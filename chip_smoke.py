"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile (or reuse) the CUDA kernels of ``demf_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version, with its time,
   the plain version's and its bound (the least time the card could take:
   the larger of its float32 operations at 67 TFLOP/s and the bytes it
   must move at 3.35 TB/s): K1 and K2 at the shapes of SA0 and of the vote
   aggregation, at batch 16 (training) and 2 (serving), K2 also on a dense
   cube where every center fills its K slots; K3 at the
   decoder's shape at batch 16 and 2 and at the encoder's at batch 2, with
   locations over the whole map and with the encoder's own (each token
   samples around its own pixel); K4, the MSDA backward, against the plain
   version's autograd at the decoder's shapes (batch 16 of 256 proposals,
   batch 4 of 300 queries) and at the encoder's shape at batch 2 and 4 on
   three kinds of locations (over the whole map, the encoder's own, those
   scattered by 4 pixels); K8, the aligned 3D NMS, keep masks equal to the
   plain version's bit for bit at a request's shape (2 scenes of 512 boxes) and
   at an eval batch's (16), on boxes spread out and on clustered boxes
   where most are suppressed, beside its bound and the least a serial sweep
   of N dependent steps could take; K9, the count of points in rotated
   boxes behind the non-empty-box test before the NMS, counts equal to the
   plain version's at a request's shape (2 scenes of 20,000 points and 512
   boxes) and an eval batch's (16), on points spread over the room and
   clustered around the boxes, beside the test it replaced (a Python loop
   of ``points_in_boxes`` over the scenes), with its launches a call (at
   most 4) and two bounds: all pairs tested, and the pairs these inputs
   need (a point in the box's bounding circle and z-range); K3 and K4 on a
   bf16 value (their bf16 entries) at the encoder's shape at batch 2 and
   4, the stage-2 decoder's and the pretrain decoder's, against the plain
   version in bf16 (one bf16 step of the largest output) and against the
   float32 kernel on the same inputs rounded to bf16, beside their bound
   with the value's bytes at 2 a number; at the decoders' shapes K4's
   row-owner route also gives the same d_value bits twice, equal to
   ``msda_backward_rows_plain``, runs no rounding pass and takes no
   memory beyond its outputs and entry lists; K11 and K12 on bf16 levels
   (their bf16 entries) at (2 and 16) x 1,000 and 16 x 512 RoIs on
   spread, crowded and piled RoIs: K11 bit for bit K11 on the levels
   widened and the plain version, K12 bf16 bit for bit the float32 K12
   rounded once (at batch 2 the plain version of its order rounded) and
   the same bits twice, beside their bounds with the levels at 2 bytes;
4. probes: with the launch counts at 0, the port's three probes at their
   full shapes (``demf_tpu_torch.tools``: K5 row gather bit-equal to the
   plain gather at BH 128 x N 22,336 x S 90,112 and at N 999 in bf16 and
   f32; K7 M-form sampler at the encoder's four levels; K5 + K6 slot fold
   at main18's shape, both weight layouts, bf16 rows), each kernel within
   its bound of the plain version and timed against it, against its
   bound and, K5 and K6, against the one PyTorch call that computes the
   same function (a yardstick: nothing in the port calls it); then the
   quad-plane route (K5 + K6, f32) against K3 at the encoder's shape
   within 1e-5 of K3's largest output; K5-K7 must each have launched;
5. reference: the full-width detector on a small input, kernels against the
   plain versions, stage predictions within 2e-3 relative;
6. serving path: DeMF-VoteNet (``configs/demf/demf_votenet.py``, full
   width, seeded random weights; its prediction stages started at the
   coder's mean class size by ``with_size_prior``, as are the training
   path's models, so that boxes hold points and K9 and K8 have work: a
   fresh model starts its sizes at 0) answers 3 requests of batch 2 at
   20,000 points and an 800x1344 image through
   ``engine.evaluation.make_eval_step``; every request must launch each
   kernel a fixed number of times; one more request runs under
   torch.profiler and prints the device time of K1-K3 and K8 on the
   model's own inputs, the device time of the post-processing (all of
   ``multiclass_nms_3d``: K9, K8 and the torch ops around them) and the
   device's busy share, and so does one request of batch 16 (an eval batch
   of the dataset path); then requests of batch 2 under the bf16 policy
   (``bf16=True``): latency, peak memory, K3's bf16 launches, one profiled,
   the stage predictions within 0.2 of each tensor's largest of the float32
   request's and finite float32 detections;
7. training reference: the full-width detector on a small input, dropout
   off, one forward + loss + backward with the kernels against one with
   the plain versions: losses within 1e-4 relative, each gradient within
   1e-3 of that tensor's largest;
8. training path: the stage-2 step at full width, batch 16 x 20,000 points
   and 800x1344 images, seeded weights: the frozen image branch fills the
   feature cache once, then 3 steps through ``engine.trainer``, each with
   finite losses and gradient norm and a fixed number of launches of each
   kernel; the image branch must stay unchanged and every other parameter
   move; K18, the vote targets, on the first step's own call against its
   plain version and through ``_vote_targets`` bit for bit;
   then the same step under the bf16 policy from the same weights,
   batch and dropout draws: its first step's losses within 0.2 of the
   float32 first step's, step time, peak memory, float32 master weights,
   optimizer state and BatchNorm statistics; between the two, the float32
   step in turns with the same step on the raw points through
   ``TrainStep(preprocess=)`` on the config's point ops (the device
   pipeline of ``data/device_pipeline.py``), and the preprocess's device
   ms;
9. dataset path: ``SyntheticSUNRGBD`` scenes of the real raw size (24,000
   points, 480x640 images) under the unchanged train and test pipelines
   of ``configs/demf/demf_votenet.py`` (20,000 points, ``Resize`` to
   (1333, 800), ``Pad`` 32), 32 train and 18 val scenes
   (``demf_tpu_torch/configs/demf_votenet_synthetic.py``), through the two
   entry points' ``main(argv)``: the loader alone (4 workers, scenes/s),
   then ``demf_tpu_torch.train`` (cache fill, one epoch of 2 steps at batch
   16, a checkpoint with meta, the eval hook), then ``demf_tpu_torch.eval``
   on that checkpoint (one full batch of 16 and one filled batch, the mAP
   printed): 18 finite results, the first one that of scene 0, the
   checkpoint's meta names the classes, and K1-K4, K8 and K9 were launched
   the expected number of times;
10. pretrain path: the stage-1 Deformable-DETR pretrain of
   ``configs/deformdetr/imvotenet_deform.py`` (the image branch trained end
   to end: ResNet-50 with ``frozen_stages=1``, the neck, 6 encoder and 6
   decoder layers, 300 queries) at full width, seeded weights, batch 4 of
   800x1344 with 20 GT slots: one forward + loss + backward with dropout
   off and the scipy solver on the kernel path against the plain path
   (losses 1e-4, gradients 1e-3 of each tensor's largest); 3 steps
   through ``engine.trainer``, each launching K3 12 times, K4 12 times and
   no other kernel, with step times and peak memory; the step's assignment
   (6 layers x 4 images, 300 queries, 20 GT) timed by the auction on the
   card and by scipy on the host; the same steps through
   ``demf_tpu_torch.train --synthetic --steps 3 --profile`` (device time by
   phase, busy share); the entry's dataset mode on ``SyntheticSUNRGBD``
   under the unchanged 2D pipeline (4 steps); and, at the tiny size, the
   hand-over: a pretrain checkpoint written by the entry warm-starts a DeMF
   model through ``load_weights`` and its serving forward runs; then 2
   steps under the bf16 policy (K3 and K4 in bf16, 12 launches each) with
   step time, peak memory and K4's device ms in a profiled step;
11. VoteNet (``configs/baseline/votenet.py``, full width, points only):
   one forward + loss + backward on the kernel path against the plain path
   at 2 x 20,000 points (losses 1e-4, gradients 1e-3 of each tensor's
   largest); 3 steps at batch 16 x 20,000 with 64 GT slots in float32 and
   under the bf16 policy (step times, scenes/s, peak memory), and 2 more
   through ``demf_tpu_torch.train --synthetic`` each; the dataset path on
   ``demf_tpu_torch/configs/votenet_synthetic.py`` (train entry: an epoch
   of 2 steps, a checkpoint, the eval hook; eval entry: 18 scenes, the mAP
   printed), with K1, K2, K8 and K9 counted; last, one forward, loss,
   backward and ``get_bboxes`` of the standard ``VoteHead`` of
   ``configs/_base_/models/votenet.py`` with the SUN RGB-D coder;
12. ImVoteNet (``configs/baseline/imvotenet.py``, full width: the caffe
   ResNet-50 + FPN + RPN + RoI head 2D branch, VoteFusion, three towers),
   its R-CNN's ``fc_cls`` scaled by 8 so that 2D boxes pass the 0.1 score
   at random weights, its regressors by 0.1 so that the boxes stay on the
   image, and the synthetic scenes' points moved into the camera's view
   (``in_view``) so that seeds fall in them: first K10 (the batched 2D NMS) bit-equal to its plain
   version at the RPN's (4,390 candidates in 5 level groups) and the
   R-CNN's (10,000 in 10 class groups) shapes at batch 16 and 2 and at its
   limit of 16,384, and K11 (the pyramid RoIAlign) at 1,000 RoIs a scene
   from the four levels of a 608x832 image at batch 16 and 2, equal bit for
   bit and held within 1e-5, each beside its bound (both in phase 3's
   list); then the kernel path against the plain path at batch 2 x 20,000
   points (towers within 2e-3 relative, 2D boxes and detections equal), 3
   requests of batch 2 with their launches (K1 7, K2 7, K10 2, K11 1, K8 1,
   K9 1), proposals, 2D boxes and seeds with image votes, one profiled; 3
   stage-2 steps at batch 16 x 20,000 points with 64 GT, the 2D branch in
   the step and unchanged after it; ``train --synthetic --steps 2
   --profile``; the dataset path on
   ``demf_tpu_torch/configs/imvotenet_synthetic.py`` through both entries;
   then under the bf16 policy beside float32: 3 requests of each (host
   ms, peak memory, launches: K11's bf16 entry), one profiled of each; the
   bf16 towers against float32's on the float32 run's 2D boxes (the mean
   error of each prediction within ``IMVOTENET_BF16_BOUND``; a vote that
   joins another group in bf16 moves one proposal wholesale, so the max is
   printed beside it) and the float32 run's 2D boxes the bf16 run keeps; 3
   bf16 steps at 16 (launches, first-step losses within 0.2 of float32's,
   device ms a step, busy share, peak memory); last one request of
   ``ImVoteNet_Deformdetr``'s fusion mode at full width under the policy;
13. the image-only Faster R-CNN (``demf_tpu_torch/configs/
   imvotenet_frcnn_synthetic.py``: ``configs/_base_/models/
   imvotenet_image.py`` trained, at full width): K12 (the RoIAlign's
   backward) against the plain version's autograd within 1e-5 of the
   largest gradient at 512 RoIs a scene, batch 16 and 2 on spread RoIs and
   batch 16 on RoIs crowded as the R-CNN's sampler hands them over and
   piled onto one box, the same bits in two calls, equal bit for bit to
   the plain version of its order at batch 2, beside its bound and the
   plain version's time; K10 at the RPN's training
   shape (16, 7,872), equal to plain; the kernel path against the plain
   path at batch 2 of 608x832 on the same draws (losses 1e-4, the FPN's,
   RPN's and RoI head's gradients 1e-3 of each tensor's largest); 3 steps
   at batch 16 x 608x832 with 64 GT (K10, K11 and K12 once a step, nothing
   else), two more profiled (device ms, busy share, phases; K10's, K11's
   and K12's device ms in the step), the anchor assigner's ms; a request of batch 2 (K10 twice, K11 once) equal to the
   plain path's; ``train --synthetic --steps 3 --profile`` and the
   dataset mode, whose checkpoint must warm-start
   ``configs/baseline/imvotenet.py``'s 2D branch with no key missing (the
   smoke's AdamW at ``FRCNN_SMOKE_LR``: at the config's 0.008 random
   weights blow up); then under the bf16 policy: 3 steps (K10, K11 bf16
   and K12 bf16 once a step), the first step's losses within 0.2 of the
   float32 first step's, K11's and K12's device ms a step
   (``tools.device_kernels``), a request of batch 2; last, a released
   mmcv-format file of the full-width DeMF-VoteNet's weights read by the
   eval entry on the dataset path's config (its CLASSES and epoch taken
   from its meta);
14. the device pipeline (M7) on ``SyntheticSUNRGBD`` at the raw size: the
   host pipeline's scenes/s against the raw loader's (``LoadRaw`` +
   ``collate_raw``) for DeMF's and ImVoteNet's train pipelines with the
   configs' 4 workers; ImVoteNet's train pipeline on the card at 16 (its
   device ms, TF32 off; its images within 5 grey levels of the host
   pipeline's on the same scenes); an epoch of ImVoteNet's step through
   ``Runner`` on the host loader and on the raw loader with
   ``TrainStep(preprocess=)``, each with its loader-wait share;
15. FCAF3D (``configs/fcaf3d/fcaf3d_sunrgbd.py``, full width: MinkResNet34
   and the FCAF3D head, 67 M parameters, seeded weights whose
   ``MaskedBatchNorm`` statistics are set from the first request's valid
   voxels by ``calibrate_batch_norms``, else random weights through 34
   layers overflow): a request of 2 scenes of 100,000 points (32,768
   voxels a scene) on the kernel path against the plain path (per-voxel
   predictions within 2e-3 relative; K15's keep masks against the plain
   NMS on the same candidates, each differing bit explained by a pair
   within 1e-5 of iou_thr, with the count printed); the request's own
   calls of K13 (17 kernel maps, equal to the plain search), K14 (47
   sparse convolutions on their tables' row plans, float32 within 1e-5 of
   each output's largest, and the same in bf16 within one bf16 step, the
   same bits twice; the GFLOP of the taps that exist and those computed on
   the tiles; timed with the plans made anew; then a dense cube and a
   scattered level at layers 1, 3 and 4's widths) and K15 (IoUs within
   1e-6 of ``iou3d_matrix`` for distinct boxes, masks equal to the plain
   sweep fed its own IoUs; also on spread, piled and coincident boxes),
   each timed
   beside its bound, its plain version and its yardstick
   (``torch.searchsorted`` + the equality test; one gather of (M, K * C)
   and one ``torch.matmul``); the request, an eval batch of 8 and a bf16
   request (K14's bf16 entry) with their launches (K13 17, K14 47, K15 1),
   host ms, device ms by kernel, busy share and peak memory, the bf16
   predictions within ``FCAF3D_BF16_BOUND`` of float32's;
16. DeMF-FCAF3D (``configs/demf/demf_fcaf3d.py``, full width, its norms
   calibrated likewise): the kernel path against the plain path at 2 x
   100,000 points and 800x1344 images (MSDA on the plain side too), then
   a request with the image branch uncached (K3 7, K13 17, K14 47, K15 1)
   and with its output carried as ``img_features`` (K3 1), which must give
   the uncached request's predictions, each with host ms, device ms by
   kernel, busy share and peak memory;
17. FCAF3D trained (``zoo.build_trainer`` on the same config, AdamW, grad
   clip 10, 8 scenes x 100,000 points): the first step's losses and every
   gradient against the same step with the sparse ops routed to their plain
   versions and in float64 (``TRAIN_LOSS_BOUND``; each gradient within
   ``grad_bound``, from ``TRAIN_GRAD_BOUND`` and ``TRAIN_GRAD_NOISE``; the
   GT boxes moved where the voxel capacity keeps voxels:
   ``fcaf3d_train_batch``); K16, the weight
   gradient, against its plain version on that step's own 47 calls (the
   same bits twice, its time, bound and a ``torch.matmul`` a tap); K14 on
   the step's 46 reverse tables (the backward's d_feats) against its plain
   version; K17, the stem's max pool, forward and backward, on that step's
   own call against its plain versions and the chain's autograd bit for
   bit (also with NaN, inf and signed zeros planted in its rows), timed
   beside the chain and a gather + ``torch.amax``; then 3 steps with their
   launches (``LAUNCHES_PER_FCAF3D_STEP``),
   finite losses, host ms, device ms by kernel, busy share, the rest of a
   profiled step's device ms by the op that launched it
   (``device_ms_by_op``) and peak memory; then the same trainer under the
   bf16 policy (``run_train_bf16``): 3 steps with their launches
   (``LAUNCHES_PER_FCAF3D_STEP_BF16``: K14, K14 on reverse tables and K16
   on their bf16 entries), the first step's losses within 0.2 of the
   float32 first step's, float32 masters, AdamW state and statistics, and
   K16's and K14's bf16 entries against their plain versions on that
   step's own calls;
18. DeMF-FCAF3D trained (decoder lr_mult 0.05, the frozen image branch's
   800x1344 features cached once): the same first-step comparison (MSDA
   plain on that side too), 3 steps (``LAUNCHES_PER_DEMF_FCAF3D_STEP``) and
   3 under the bf16 policy (``LAUNCHES_PER_DEMF_FCAF3D_STEP_BF16``); then
   the train entry, ``--synthetic --steps 2``, on both tiny FCAF3D
   configs.

The entry surface of the JAX package (M4), in four more phases, each with
its launches counted: after the serving requests, the flip aug-test
(``engine/aug_test.py::aug_test_3d``) on a request of batch 2: twice a
request's launches and one K8 for the merge, whose 10,240 detections a
scene are merged by (scene, class) rows, equal to the merge's plain
version, and its latency; after the training path, the train entry under
``--launcher pytorch`` in a subprocess (NCCL, rank 0 of 1:
``run_launcher_path``): each of its 3 steps launches what a training-path
step launches, its step ms printed beside theirs; then two ranks on the
one card over gloo (``run_two_rank_step``, ``tools/dp_equivalence.py``):
DeMF-VoteNet stage 2 at full width, every dropout 0, 16 scenes split 8 + 8,
against one process on the 16 and one on the 16 in reverse order (the
float32 noise of regrouping the sums over scenes): the first step's loss,
every gradient after the all-reduce and every running statistic within
``TWO_RANK_NOISE`` times that noise (or an absolute floor), the ranks'
parameters the same bits after 2 steps, the step's ms and its gloo
all-reduce's share; in the dataset path, the eval entry again with
``--fuse-conv-bn --show-dir`` on the same checkpoint and draws
(``check_fused_eval``): its detections matched to the unfused ones, the
folded model's forward held to the unfused one output by output, and three
``.obj`` files a scene.

The line before the last is the kernel table as JSON (K1-K3: launches
counted in the training path, times and bound at its shape, each kernel's
first row above; K4: launches counted in the pretrain path's 3 steps, times
and bound at the encoder's shape at batch 4, its own locations; K3 in bf16:
launches of the bf16 requests, times and bound at the encoder's shape at
batch 2; K4 in bf16: launches of the bf16 pretrain steps, times and bound
at the encoder's shape at batch 4;
``launches_by_path`` has every path's count; K5-K7: launches counted in
the probes phase, times and bound of K5 at the gather probe's shape, K6 in the (LP, Q, 4) layout on
one chunk, K7 at the finest level; K8 and K9: launches counted in the
dataset path, times and bound at an eval batch's shape; K10 and K11:
launches counted in the ImVoteNet requests, times and bound at a request's
shape (the R-CNN's 10,000 candidates; 2 x 1,000 RoIs); K12: launches
counted in the image-only steps, times and bound at their shape (16 x 512
RoIs); K11 bf16: launches of the bf16 ImVoteNet requests, times and bound
at a request's shape (2 x 1,000 RoIs); K12 bf16: launches of the bf16
image-only steps, times and bound at (16, 512); K13-K15: launches of an
FCAF3D request, times and bounds summed over that request's own calls (K14
bf16: launches of the bf16 request; K14's plan: its 16 tables, bound by
their bytes; K14's row also carries ``backward_launches``, a FCAF3D train
step's); K14 on reverse tables (``sparse_conv_backward``) and K16: launches
of a FCAF3D train step, times and bounds summed over its own calls (their
bf16 entries, ``sparse_conv_backward_bf16`` and
``sparse_conv_dweights_bf16``: the bf16 step's, bound at bf16's peak);
K17 (``sparse_max_pool``, ``sparse_max_pool_backward`` and their bf16
entries): launches of a FCAF3D train step (bf16: the bf16 step's), times
and bounds on its own call; K18 (``vote_targets``): launches of the
DeMF-VoteNet training path's 3 steps, times and bound on its first step's
call; ``library_ms`` is
the one
PyTorch call that computes the kernel's function (K5 an indexing call, K6
an einsum, K7 an ``embedding_bag`` with weights, K13 ``searchsorted``, K14
a gather and a matmul, K16 a gather and a matmul a tap, K17 a gather and
``torch.amax``, its backward that call's autograd) and null where
there is
none: FPS, the exact ball query, MSDA and its backward, the class-aware
3D NMS, the count of points in rotated boxes, the vote targets,
and the 2D NMS and RoIAlign
(forward and backward), which torchvision has and this machine does not);
the
last line is ``{"ok": true, "device": {...}}``.
Float32 but for the bf16 phases: TF32 is switched off for matmuls and
cuDNN convolutions.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

# every kernel's count, as ops.kernels() names them (K3 and K4 count their
# float32 and their bfloat16 launches apart)
KERNEL_NAMES = ('fps', 'ball_query', 'msda', 'msda_backward', 'msda_bf16',
                'msda_backward_bf16', 'gather_rows', 'msda_fold',
                'mform_sample', 'nms3d', 'box_count', 'nms2d', 'roi_align',
                'roi_align_backward', 'roi_align_bf16',
                'roi_align_backward_bf16', 'kernel_map', 'sparse_conv',
                'sparse_conv_bf16', 'sparse_conv_plan', 'nms3d_rotated',
                'sparse_conv_backward', 'sparse_conv_dweights',
                'sparse_conv_backward_bf16', 'sparse_conv_dweights_bf16',
                'sparse_max_pool', 'sparse_max_pool_bf16',
                'sparse_max_pool_backward', 'sparse_max_pool_backward_bf16',
                'vote_targets')


def launch_counts(**counts):
    """What a run must launch: ``counts``, and 0 of every other kernel."""
    return {n: counts.get(n, 0) for n in KERNEL_NAMES}


# requests per run and what each must launch (4 SA + 1 vote aggregation for
# FPS and ball query; 6 encoder layers + 1 decoder layer for MSDA)
REQUESTS = (0, 1, 2)
LAUNCHES_PER_REQUEST = launch_counts(fps=5, ball_query=5, msda=7, nms3d=1,
                                     box_count=1)
# train steps per run and what each must launch (the image branch runs
# once, before, to fill the feature cache; the vote targets' slots once,
# in the head's loss)
TRAIN_STEPS = 3
TRAIN_BATCH = dict(b=16, p=20000, g=64, hw=(800, 1344))
LAUNCHES_PER_STEP = launch_counts(fps=5, ball_query=5, msda=1,
                                  msda_backward=1, vote_targets=1)
# under the bf16 policy the MSDA layers take bf16 values: K3 and K4 run
# their bf16 entries; FPS, the ball query, K8 and K9 stay float32
LAUNCHES_PER_REQUEST_BF16 = launch_counts(fps=5, ball_query=5, msda_bf16=7,
                                          nms3d=1, box_count=1)
LAUNCHES_PER_STEP_BF16 = launch_counts(fps=5, ball_query=5, msda_bf16=1,
                                       msda_backward_bf16=1, vote_targets=1)
# bf16 against float32 stage predictions of a full-width request, of each
# tensor's largest: 2.2e-2 measured on an H100 (PERF.md), a limit with some
# room above it that a stage off by a tenth would break
SERVE_BF16_BOUND = 5e-2
# VoteNet (configs/baseline/votenet.py): 4 SA + the vote aggregation around
# the FPS of the seeds, points only; a request also runs K9 and K8
VOTENET_CFG = 'baseline/votenet.py'
VOTENET_STEPS = 3
VOTENET_BATCH = dict(b=16, p=20000, g=64)
LAUNCHES_PER_VOTENET_STEP = launch_counts(fps=5, ball_query=5, vote_targets=1)
LAUNCHES_PER_VOTENET_REQUEST = launch_counts(fps=5, ball_query=5, nms3d=1,
                                             box_count=1)
VOTENET_DATASET_CFG = os.path.join('demf_tpu_torch', 'configs',
                                   'votenet_synthetic.py')
# the dataset path: 32 train scenes (2 batches of 16: the cache fill runs
# the encoder's 6 MSDA layers on each, the epoch 2 steps) and 18 val scenes
# (2 batches, the second filled), read by the train entry's eval hook and
# again by the eval entry
DATASET_CFG = os.path.join('demf_tpu_torch', 'configs',
                           'demf_votenet_synthetic.py')
EVAL_BATCHES = 2
VAL_SCENES = 18
TRAIN_BATCH_SHAPES = ((16, 20000, 4), (16, 800, 1088, 3))   # points, images
LAUNCHES_TRAIN_ENTRY = {
    n: 2 * LAUNCHES_PER_STEP[n] + EVAL_BATCHES * LAUNCHES_PER_REQUEST[n]
    for n in LAUNCHES_PER_STEP}
LAUNCHES_TRAIN_ENTRY['msda'] += 2 * 6
LAUNCHES_EVAL_ENTRY = {n: EVAL_BATCHES * c
                       for n, c in LAUNCHES_PER_REQUEST.items()}
# the VoteNet dataset path: an epoch of 2 steps and the eval hook's 2
# batches, then the eval entry's 2 batches
LAUNCHES_VOTENET_TRAIN_ENTRY = {
    n: 2 * LAUNCHES_PER_VOTENET_STEP[n] +
    EVAL_BATCHES * LAUNCHES_PER_VOTENET_REQUEST[n] for n in KERNEL_NAMES}
LAUNCHES_VOTENET_EVAL_ENTRY = {
    n: EVAL_BATCHES * c for n, c in LAUNCHES_PER_VOTENET_REQUEST.items()}
# the probes' kernels: their launches are counted over the probes phase
PROBE_KERNELS = ('gather_rows', 'msda_fold', 'mform_sample')
REPLACES = {
    'fps': 'demf_tpu/ops/pallas/fps.py:60',
    'ball_query': 'demf_tpu/ops/grouping.py:38',
    'msda': 'demf_tpu/ops/msda.py:975',
    'msda_backward': 'demf_tpu/ops/msda.py:572',
    'msda_bf16': 'demf_tpu/ops/msda.py:975',
    'msda_backward_bf16': 'demf_tpu/ops/msda.py:572',
    'gather_rows': 'demf_tpu/ops/pallas/gather_rows.py:81',
    'msda_fold': 'demf_tpu/ops/pallas/msda_fold.py:113',
    'mform_sample': 'tools/bench_msda_matmul.py:73',
    'nms3d': 'demf_tpu/ops/nms.py:46',
    'box_count': 'demf_tpu/core/boxes.py:105',
    'nms2d': 'demf_tpu/ops/nms.py:119',
    'roi_align': 'demf_tpu/models/rpn_roi.py:167',
    'roi_align_backward': 'demf_tpu/models/rpn_roi.py:199',
    'roi_align_bf16': 'demf_tpu/models/rpn_roi.py:167',
    'roi_align_backward_bf16': 'demf_tpu/models/rpn_roi.py:199',
    'kernel_map': 'demf_tpu/ops/sparse.py:321',
    'sparse_conv': 'demf_tpu/ops/sparse.py:393',
    'sparse_conv_bf16': 'demf_tpu/ops/sparse.py:393',
    # the plan has no JAX code of its own: index plumbing of K14's function
    'sparse_conv_plan': 'demf_tpu/ops/sparse.py:393',
    'nms3d_rotated': 'demf_tpu/models/fcaf3d.py:314',
    # d_feats: the same gather-GEMM on the reverse table (_conv_sym_bwd,
    # _conv_revgeo_bwd)
    'sparse_conv_backward': 'demf_tpu/ops/sparse.py:450',
    'sparse_conv_dweights': 'demf_tpu/ops/sparse.py:414',
    'sparse_conv_backward_bf16': 'demf_tpu/ops/sparse.py:450',
    'sparse_conv_dweights_bf16': 'demf_tpu/ops/sparse.py:414',
    # the scan over taps (:652-659) and its autograd
    'sparse_max_pool': 'demf_tpu/ops/sparse.py:636',
    'sparse_max_pool_bf16': 'demf_tpu/ops/sparse.py:636',
    'sparse_max_pool_backward': 'demf_tpu/ops/sparse.py:636',
    'sparse_max_pool_backward_bf16': 'demf_tpu/ops/sparse.py:636',
    'vote_targets': 'demf_tpu/models/target_assign.py:30',
}
SOURCES = {'fps': 'demf_tpu_torch/csrc/fps.cu',
           'ball_query': 'demf_tpu_torch/csrc/ball_query.cu',
           'msda': 'demf_tpu_torch/csrc/msda.cu',
           'msda_backward': 'demf_tpu_torch/csrc/msda_backward.cu',
           'msda_bf16': 'demf_tpu_torch/csrc/msda.cu',
           'msda_backward_bf16': 'demf_tpu_torch/csrc/msda_backward.cu',
           'gather_rows': 'demf_tpu_torch/csrc/gather_rows.cu',
           'msda_fold': 'demf_tpu_torch/csrc/msda_fold.cu',
           'mform_sample': 'demf_tpu_torch/csrc/mform_sample.cu',
           'nms3d': 'demf_tpu_torch/csrc/nms3d.cu',
           'box_count': 'demf_tpu_torch/csrc/box_count.cu',
           'nms2d': 'demf_tpu_torch/csrc/nms2d.cu',
           'roi_align': 'demf_tpu_torch/csrc/roi_align.cu',
           'roi_align_backward': 'demf_tpu_torch/csrc/roi_align.cu',
           'roi_align_bf16': 'demf_tpu_torch/csrc/roi_align.cu',
           'roi_align_backward_bf16': 'demf_tpu_torch/csrc/roi_align.cu',
           'kernel_map': 'demf_tpu_torch/csrc/kernel_map.cu',
           'sparse_conv': 'demf_tpu_torch/csrc/sparse_conv.cu',
           'sparse_conv_bf16': 'demf_tpu_torch/csrc/sparse_conv.cu',
           'sparse_conv_plan': 'demf_tpu_torch/csrc/sparse_conv.cu',
           'nms3d_rotated': 'demf_tpu_torch/csrc/nms3d_rotated.cu',
           'sparse_conv_backward': 'demf_tpu_torch/csrc/sparse_conv.cu',
           'sparse_conv_dweights': 'demf_tpu_torch/csrc/sparse_dweights.cu',
           'sparse_conv_backward_bf16': 'demf_tpu_torch/csrc/sparse_conv.cu',
           'sparse_conv_dweights_bf16':
               'demf_tpu_torch/csrc/sparse_dweights.cu',
           'sparse_max_pool': 'demf_tpu_torch/csrc/sparse_pool.cu',
           'sparse_max_pool_bf16': 'demf_tpu_torch/csrc/sparse_pool.cu',
           'sparse_max_pool_backward': 'demf_tpu_torch/csrc/sparse_pool.cu',
           'sparse_max_pool_backward_bf16':
               'demf_tpu_torch/csrc/sparse_pool.cu',
           'vote_targets': 'demf_tpu_torch/csrc/vote_targets.cu'}
MSDA_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))
# the stage-1 pretrain path: the model of configs/deformdetr/
# imvotenet_deform.py, a batch of 4 images of 800x1344 with 20 GT slots; a
# step runs 6 encoder and 6 decoder MSDA layers forward (K3) and backward
# (K4) and none of the point branch's kernels
PRETRAIN_CFG = 'deformdetr/imvotenet_deform.py'
PRETRAIN_BATCH = dict(b=4, hw=(800, 1344), g=20)
PRETRAIN_STEPS = 3
LAUNCHES_PER_PRETRAIN_STEP = launch_counts(msda=12, msda_backward=12)
LAUNCHES_PER_PRETRAIN_STEP_BF16 = launch_counts(msda_bf16=12,
                                                msda_backward_bf16=12)
PRETRAIN_DATASET_CFG = os.path.join('demf_tpu_torch', 'configs',
                                    'detr_pretrain_synthetic.py')
PRETRAIN_TINY_CFG = os.path.join('demf_tpu_torch', 'configs',
                                 'detr_pretrain_tiny.py')
# ImVoteNet (configs/baseline/imvotenet.py): a request runs the Faster
# R-CNN branch (K10 over the RPN's level groups and the R-CNN's class
# groups, K11 once), 4 SA and 3 tower aggregations around the FPS of the
# seeds, and the joint tower's post-processing; a step the same but the
# post-processing, and the vote targets' slots in each tower's loss.
# Scenes of 608x832 (a 530x730 frame under Resize (1333, 600) and Pad 32)
IMVOTENET_CFG = 'baseline/imvotenet.py'
IMVOTENET_REQUEST = dict(b=2, p=20000, hw=(608, 832), valid_hw=(600, 826))
LAUNCHES_PER_IMVOTENET_REQUEST = launch_counts(
    fps=7, ball_query=7, nms2d=2, roi_align=1, nms3d=1, box_count=1)
LAUNCHES_PER_IMVOTENET_STEP = launch_counts(fps=7, ball_query=7, nms2d=2,
                                            roi_align=1, vote_targets=3)
# under the bf16 policy the FPN's levels are bf16: K11 runs its bf16 entry
LAUNCHES_PER_IMVOTENET_REQUEST_BF16 = launch_counts(
    fps=7, ball_query=7, nms2d=2, roi_align_bf16=1, nms3d=1, box_count=1)
LAUNCHES_PER_IMVOTENET_STEP_BF16 = launch_counts(
    fps=7, ball_query=7, nms2d=2, roi_align_bf16=1, vote_targets=3)
# bf16 against float32 towers of a full-width ImVoteNet request on the
# same 2D boxes, of each tensor's largest: the bound the CPU tests hold the
# port's bf16 predictions to its float32 ones (tests/test_engine.py's 0.2);
# SERVE_BF16_BOUND is DeMF's, whose measured gap it was set above
IMVOTENET_BF16_BOUND = 0.2
# ImVoteNet_Deformdetr's fusion under the bf16 policy: the DETR's 6 encoder
# and 6 decoder MSDA layers on bf16 values, the point branch and towers
LAUNCHES_DEFORMDETR_FUSION_BF16 = launch_counts(
    fps=7, ball_query=7, msda_bf16=12, nms3d=1, box_count=1)
IMVOTENET_STEPS = 3
IMVOTENET_STEP_BATCH = (16, 608, 832)          # scenes, image
# random weights score the R-CNN's 11 classes near 1 / 11, under the
# config's score_thr of 0.1: fc_cls scaled by this on both paths makes the
# R-CNN confident, so that 2D boxes pass; and their random box deltas
# (exp'd up to 62x) throw the boxes off the image, where the clip leaves
# them flat: the RPN's and the R-CNN's regressors scaled by the second keep
# the boxes near their anchors, so that seeds fall in them
RCNN_CONFIDENCE = 8.0
REGRESSOR_SCALE = 0.1
IMVOTENET_DATASET_CFG = os.path.join('demf_tpu_torch', 'configs',
                                     'imvotenet_synthetic.py')
LAUNCHES_IMVOTENET_TRAIN_ENTRY = {
    n: 2 * LAUNCHES_PER_IMVOTENET_STEP[n] +
    EVAL_BATCHES * LAUNCHES_PER_IMVOTENET_REQUEST[n] for n in KERNEL_NAMES}
LAUNCHES_IMVOTENET_EVAL_ENTRY = {
    n: EVAL_BATCHES * c for n, c in LAUNCHES_PER_IMVOTENET_REQUEST.items()}
# the shapes K10 is held and timed at: the RPN's 5 level groups and the
# R-CNN's 10 class groups, at a request's batch and a step's, and K10's
# limit (K11's and K12's levels: tools/roi_cases.py)
NMS2D_SHAPES = ((16, 'rcnn', 10000, 0.5), (16, 'rpn', 4390, 0.7),
                (2, 'rcnn', 10000, 0.5), (2, 'rpn', 4390, 0.7),
                (2, 'random', 16384, 0.7))
# the image-only Faster R-CNN (demf_tpu_torch/configs/imvotenet_frcnn_
# synthetic.py: configs/_base_/models/imvotenet_image.py, trained): a step
# runs K10 once over the RPN's training proposals (7,872 candidates in 5
# level groups at 608x832), K11 once over the 512 RoIs an image its R-CNN
# samples and K12 once in the backward; a request K10 over the proposals
# and over the R-CNN's class groups, and K11 once.  The dataset mode: 32
# scenes, 2 steps at batch 16
FRCNN_CFG = os.path.join('demf_tpu_torch', 'configs',
                         'imvotenet_frcnn_synthetic.py')
FRCNN_STEPS = 3
FRCNN_STEP_BATCH = (16, 608, 832)
FRCNN_ROIS = 512
LAUNCHES_PER_FRCNN_STEP = launch_counts(nms2d=1, roi_align=1,
                                        roi_align_backward=1)
LAUNCHES_PER_FRCNN_REQUEST = launch_counts(nms2d=2, roi_align=1)
LAUNCHES_PER_FRCNN_STEP_BF16 = launch_counts(
    nms2d=1, roi_align_bf16=1, roi_align_backward_bf16=1)
LAUNCHES_PER_FRCNN_REQUEST_BF16 = launch_counts(nms2d=2, roi_align_bf16=1)
FRCNN_DATASET_STEPS = 2
# AdamW at the config's lr of 0.008 moves every random weight of the
# backbone by a quarter of its size in a step, and the losses reach 1e16 by
# the second: proposals and sampled RoIs then pile up on the image's
# borders.  The smoke's steps and entry runs take this lr instead, so that
# its RoIs stay spread as a training run's do (the config is unchanged)
FRCNN_SMOKE_LR = 8e-5


def kernel_row(max_abs_err, ms, plain_ms, bound_ms, bound_by,
               library_ms=None):
    """A kernel's measured part of the ``kernels`` line; ``library_ms``
    stays None where no single PyTorch call computes its function."""
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_fps(dev, rng):
    from demf_tpu_torch.ops import sampling
    from demf_tpu_torch.tools import bound_ms, time_ms
    rows = []
    for b, n, k in ((16, 20000, 2048), (16, 1024, 256), (2, 20000, 2048),
                    (2, 1024, 256)):
        xyz = torch.from_numpy(
            rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)).to(dev)
        got = sampling.furthest_point_sample_cuda(xyz, k)
        want = sampling.furthest_point_sample_plain(xyz, k)
        err = int((got - want).abs().max())
        ms = time_ms(lambda: sampling.furthest_point_sample_cuda(xyz, k), 5)
        plain_ms = time_ms(
            lambda: sampling.furthest_point_sample_plain(xyz, k), 1)
        # a step: 3 sub, 3 mul, 2 add, a min and a compare for every point
        least, by = bound_ms(10 * b * (k - 1) * n, b * n * 12 + b * k * 8)
        print(f'K1 fps ({b}, {n}) -> {k}: max_abs_err {err} (index), kernel '
              f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {least:.4f} ms '
              f'({by})')
        if err != 0:
            raise AssertionError(f'FPS kernel picks differ from plain '
                                 f'({b}, {n})')
        rows.append(kernel_row(err, ms, plain_ms, least, by))
    return rows[0]


def _ball_sets_agree(points, centers, got, want, radius, k):
    """Per-center set comparison, skipping centers with a point within 1e-5
    of r^2 or within 1e-6 of the K-th distance.  Returns (compared share,
    number of compared centers that differ)."""
    from demf_tpu_torch.ops.grouping import sqdist
    d2 = sqdist(centers, points)                       # (B, M, N)
    r2 = radius * radius
    near_r = ((d2 - r2).abs() < 1e-5).any(-1)
    inside = torch.where(d2 < r2, d2, torch.full_like(d2, float('inf')))
    kth = torch.sort(inside, -1).values[..., k - 1:k]
    near_k = (torch.isfinite(kth) &
              ((inside - kth).abs() < 1e-6)).sum(-1) > 1
    ok = ~(near_r | near_k)
    same = (torch.sort(got, -1).values ==
            torch.sort(want, -1).values).all(-1)
    return ok.float().mean().item(), int((ok & ~same).sum())


def check_ball_query(dev, rng):
    """K2 at the shapes of SA0 and of the vote aggregation, batch 16 and 2,
    on points drawn over a cube of 6 m (about 3 in SA0's ball) and, at
    SA0's shape, over one of 2 m with an eighth of them twice (about 80 in
    the ball: every center fills its K slots, and equal distances occur).
    Against the plain version, whose matmul rounds the distances
    differently, the picks are compared as sets on the centers where that
    cannot matter; on the dense cube also pick for pick against the plain
    version on distances rounded as the kernel rounds them."""
    from demf_tpu_torch.ops import grouping
    from demf_tpu_torch.tools import bound_ms, time_ms
    rows = []
    for b, n, m, k, r, lo, twice in ((16, 20000, 2048, 64, 0.2, 3.0, 0),
                                     (16, 1024, 256, 16, 0.3, 1.0, 0),
                                     (2, 20000, 2048, 64, 0.2, 3.0, 0),
                                     (2, 1024, 256, 16, 0.3, 1.0, 0),
                                     (16, 20000, 2048, 64, 0.2, 1.0, 2500),
                                     (2, 20000, 2048, 64, 0.2, 1.0, 2500)):
        pts = rng.uniform(-lo, lo, (b, n, 3)).astype(np.float32)
        pts[:, n // 2:n // 2 + twice] = pts[:, :twice]
        pts = torch.from_numpy(pts).to(dev)
        centers = pts[:, :m].contiguous()
        got = grouping.ball_query_cuda(r, k, pts, centers)
        want = grouping.ball_query_plain(r, k, pts, centers)
        share, bad = _ball_sets_agree(pts, centers, got, want, r, k)
        ms = time_ms(lambda: grouping.ball_query_cuda(r, k, pts, centers), 10)
        plain_ms = time_ms(
            lambda: grouping.ball_query_plain(r, k, pts, centers), 3)
        # a pair: 3 sub, 3 mul, 2 add and the compare with r^2
        least, by = bound_ms(9 * b * m * n,
                             b * (n + m) * 12 + b * m * k * 8)
        exact = ''
        if twice:
            same = torch.equal(got, grouping.ball_query_plain(
                r, k, pts, centers, distances=grouping.sqdist_unfused))
            exact = (f", pick for pick equal to plain on the kernel's "
                     f'roundings: {same}')
            bad += not same
        print(f'K2 ball_query ({b}, M {m}, N {n}, K {k}, r {r}, '
              f'{"dense" if twice else "sparse"}): compared '
              f'{share:.4%} of centers, {bad} differ{exact}, kernel '
              f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {least:.4f} ms '
              f'({by})')
        # on the dense cube a center whose K-th neighbour occurs twice is
        # left out of the set comparison (and held pick for pick instead)
        if share < (0.5 if twice else 0.99) or bad:
            raise AssertionError('ball query kernel disagrees with plain')
        rows.append(kernel_row(bad, ms, plain_ms, least, by))
    return rows[0]


# what the sweep's dependent chain costs a box (a test of its bit and an OR
# into the removed mask, ~4 clocks of dependent latency each): a reckoning,
# not a measurement
SWEEP_CLOCKS_A_BOX = 8


def max_sm_clock_hz():
    """The card's highest SM clock, as nvidia-smi gives it."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def check_nms(dev):
    """K8 against the plain version, masks equal, at an eval batch's shape
    and a request's, 10 classes: boxes spread over a cube of 6 m (few
    overlaps) and boxes clustered around a few centers (most suppressed).
    Its bound counts the IoUs the sweep can ask for on these inputs, the
    pairs of valid boxes of one class (22 operations a pair); beside it
    stands the least a serial sweep of N dependent steps could take at the
    card's highest clock."""
    from demf_tpu_torch.ops import nms
    from demf_tpu_torch.tools import bound_ms, time_ms
    from demf_tpu_torch.tools.nms_cases import nms_case
    rows = []
    clock_hz = max_sm_clock_hz()
    for b, n, kind in ((16, 512, 'random'), (16, 512, 'clustered'),
                       (2, 512, 'random'), (2, 512, 'clustered')):
        boxes, scores, classes, valid = (
            torch.from_numpy(a).to(dev) for a in nms_case(kind, b, n, seed=b))
        got = nms.aligned_3d_nms_cuda(boxes, scores, classes, 0.25, valid)
        want = nms.aligned_3d_nms_plain(boxes, scores, classes, 0.25, valid)
        differ = int((got != want).sum())
        ms = time_ms(lambda: nms.aligned_3d_nms_cuda(
            boxes, scores, classes, 0.25, valid), 20)
        plain_ms = time_ms(lambda: nms.aligned_3d_nms_plain(
            boxes, scores, classes, 0.25, valid), 1)
        # boxes of a scene and a class: m of them make m (m - 1) / 2 pairs
        sizes = torch.stack([((classes == c) & valid).sum(1)
                             for c in classes.unique()])
        pairs = int((sizes * (sizes - 1) // 2).sum())
        least, by = bound_ms(22 * pairs,
                             b * n * (24 + 4 + 8 + 1) + got.numel())
        sweep_ms = n * SWEEP_CLOCKS_A_BOX / clock_hz * 1e3
        print(f'K8 nms3d ({b}, N {n}, 10 classes, {kind}): kept '
              f'{int(got.sum())} of {int(valid.sum())} valid, {differ} mask '
              f'bits differ from plain, kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {least:.6f} ms ({by}; {pairs} '
              f'pairs of one class), a serial sweep of {n} steps at '
              f'{clock_hz / 1e6:.0f} MHz at least {sweep_ms:.6f} ms')
        if differ:
            raise AssertionError('NMS kernel keep masks differ from plain')
        rows.append(kernel_row(differ, ms, plain_ms, least, by))
    return rows[0]


def kernels_a_call(fn, groups, runs=5):
    """{label: (device ms a call, kernels a call)} of the kernels whose
    name holds one of the label's markers, and 'all' for every kernel of
    ``fn`` (``tools.device_kernels`` over ``runs`` calls).  Deep in this
    script torch.profiler records a kernel in only some calls, so each
    kernel's time is its ms a recorded launch times its launches a call
    (the recorded mean, rounded up)."""
    from demf_tpu_torch.tools import device_kernels
    out = {label: [0.0, 0] for label in list(groups) + ['all']}
    for name, (n, ms) in device_kernels(fn, runs).items():
        launches = int(np.ceil(n - 1e-6))
        hit = [label for label, markers in groups.items()
               if any(m in name for m in markers)] + ['all']
        for label in hit:
            out[label][0] += ms / n * launches
            out[label][1] += launches
    return {k: tuple(v) for k, v in out.items()}


def device_ms(fn, marker, runs=5):
    """Device ms of one call of ``fn`` (``kernels_a_call``): (the kernels
    whose name holds ``marker``, all its kernels, how many kernels a
    call)."""
    found = kernels_a_call(fn, {'ours': (marker,)}, runs)
    return found['ours'][0], found['all'][0], found['all'][1]


# K9's launches in one call: the yaw's cosine and sine, its bin kernel and
# its count kernel
BOX_COUNT_LAUNCHES = 4


def check_box_count(dev):
    """K9 against the plain count at a request's shape and an eval batch's
    (20,000 points of (B, P, 4), read through their strides, and 512
    boxes), points spread over the room and clustered around the boxes:
    counts equal, and at most ``BOX_COUNT_LAUNCHES`` launches a call.
    Beside it, the non-empty-box test as ``multiclass_nms_3d`` ran it before
    K9: ``points_in_boxes`` in a Python loop over the scenes.  Two bounds,
    each with the kernel's share of it: all pairs tested (12 float32
    operations a (point, box) test: 3 subtracts, 4 multiplies, 2 adds, 3
    comparisons of absolute values), and the pairs these inputs need, a
    point within the box's bounding circle and its z-range
    (``tools.box_pairs_in_reach``), which the culled kernel can beat only
    by cutting work the bound counts; the row takes the second."""
    from demf_tpu_torch.core import boxes as box_ops
    from demf_tpu_torch.ops import box_count
    from demf_tpu_torch.tools import (bound_ms, box_pairs_in_reach,
                                      device_kernels, time_ms)
    from demf_tpu_torch.tools.nms_cases import box_count_case
    rows = []
    for b, kind in ((16, 'clustered'), (16, 'spread'), (2, 'clustered'),
                    (2, 'spread')):
        points, boxes = (torch.from_numpy(a).to(dev) for a in box_count_case(
            kind, b, 20000, 512, seed=b))
        got = box_count.box_point_count_cuda(points, boxes)
        want = box_count.box_point_count_plain(points, boxes)
        differ = int((got != want).sum())
        ms = time_ms(lambda: box_count.box_point_count_cuda(points, boxes), 20)
        plain_ms = time_ms(
            lambda: box_count.box_point_count_plain(points, boxes), 3)

        def loop():
            return torch.stack([
                box_ops.points_in_boxes(points[i, :, :3], boxes[i]).sum(0) > 5
                for i in range(b)])

        loop_ms = time_ms(loop, 3)
        alone, wrapper, kinds = device_ms(
            lambda: box_count.box_point_count_cuda(points, boxes),
            'box_count')
        found = device_kernels(
            lambda: box_count.box_point_count_cuda(points, boxes))
        launches = round(sum(n for n, _ in found.values()))
        same_mask = torch.equal(loop(), got > 5)
        p, n = points.shape[1], boxes.shape[1]
        nbytes = points.numel() * 4 + boxes.numel() * 4 + got.numel() * 4
        all_pairs, all_by = bound_ms(12 * b * p * n, nbytes)
        needed = box_pairs_in_reach(points, boxes)
        least, by = bound_ms(12 * needed, nbytes)
        print(f'K9 box_count ({b}, {p} points, {n} boxes, {kind}): '
              f'{(got > 5).float().mean().item():.1%} of the boxes non-empty, '
              f'{differ} counts differ from plain, mask equal to the loop\'s: '
              f'{same_mask}; kernel {ms:.4f} ms through the wrapper (on the '
              f'device: K9\'s kernels {alone:.4f} ms, the wrapper\'s '
              f'{kinds} launches {wrapper:.4f} ms; launches a call '
              f'{launches}: {", ".join(found)}), plain {plain_ms:.4f} ms, '
              f'the loop it '
              f'replaced {loop_ms:.4f} ms; bound of all pairs {all_pairs:.6f}'
              f' ms ({all_by}), K9 on the device at '
              f'{all_pairs / max(alone, 1e-9):.1%} of it; bound of the '
              f'{needed} pairs in reach ({needed / (b * p * n):.2%} of all) '
              f'{least:.6f} ms ({by}), at {least / max(alone, 1e-9):.1%} of '
              f'it', flush=True)
        if differ or not same_mask:
            raise AssertionError('box count kernel disagrees with plain')
        if launches > BOX_COUNT_LAUNCHES:
            raise AssertionError(f'K9 launched {launches} kernels in a call, '
                                 f'expected at most {BOX_COUNT_LAUNCHES}')
        rows.append(kernel_row(differ, ms, plain_ms, least, by))
    return rows[0]


def msda_bytes(shapes, value, locs, aw, backward=False):
    """What MSDA must move for these inputs: the value rows its samples
    touch, locations, weights and the output; the backward also reads the
    output's gradient and writes all three gradients (d_value in full).
    The value, the output, its gradient and d_value count the value's
    element size (2 bytes in bf16), locations and weights 4."""
    from demf_tpu_torch.tools import msda_rows_touched
    hd = value.shape[-1]
    out = value.shape[0] * locs.shape[1] * value.shape[2] * hd
    rows = msda_rows_touched(shapes, locs) * hd + out
    small = locs.numel() + aw.numel()
    if backward:    # the output's place is grad_out's, read once
        rows += value.numel()
        small += locs.numel() + aw.numel()
    return value.element_size() * rows + 4 * small


def check_msda(dev, rng):
    from demf_tpu_torch.ops import msda
    from demf_tpu_torch.tools import (bound_ms, encoder_sampling_locations,
                                      time_ms)
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    rows = []
    # the stage-2 step's and the request's decoder, the request's encoder,
    # and the pretrain step's encoder and decoder at batch 4
    for b, q, p, own in ((16, 256, 2, False), (2, 256, 2, False),
                         (2, s, 4, False), (2, s, 4, True),
                         (4, s, 4, False), (4, s, 4, True),
                         (4, 300, 4, False)):
        value = torch.from_numpy(
            rng.randn(b, s, 8, 32).astype(np.float32)).to(dev)
        if own:     # the encoder's: every token samples around its own pixel
            locs = encoder_sampling_locations(shapes, b, 8, p, dev)
        else:
            locs = torch.from_numpy(rng.uniform(
                -0.1, 1.1, (b, q, 8, 4, p, 2)).astype(np.float32)).to(dev)
        aw = torch.from_numpy(rng.rand(b, q, 8, 4 * p).astype(np.float32))
        aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p).to(dev)
        got = msda.msda_cuda(value, shapes, locs, aw)
        want = msda.msda_plain(value, shapes, locs, aw)
        err = (got - want).abs().max().item()
        bound = 1e-5 * want.abs().max().item()
        ms = time_ms(lambda: msda.msda_cuda(value, shapes, locs, aw), 10)
        plain_ms = time_ms(lambda: msda.msda_plain(value, shapes, locs, aw),
                           3)
        # a sample and channel: 4 corners and the weight, an FMA each
        least, by = bound_ms(10 * aw.numel() * 32,
                             msda_bytes(shapes, value, locs, aw))
        where = ("the encoder's own locations" if own
                 else 'locations over the whole map')
        print(f'K3 msda ({b}, Q {q}, heads 8, hd 32, L 4, P {p}, sum_HW {s}, '
              f'{where}): max_abs_err {err:.3e} (bound {bound:.3e}), kernel '
              f'{ms:.4f} ms, plain {plain_ms:.4f} ms, least {least:.4f} ms '
              f'({by})')
        if not err <= bound:
            raise AssertionError('MSDA kernel disagrees with plain')
        rows.append(kernel_row(err, ms, plain_ms, least, by))
        del value, locs, aw, got, want
        torch.cuda.empty_cache()
    return rows[0]


def check_msda_backward(dev, rng):
    """K4 against the plain version's autograd: at the decoder's shapes
    (batch 16, Q 256, P 2 of the stage-2 step; batch 4, Q 300, P 4 of the
    pretrain step) with locations over the whole map, crowded round 16
    centres a scene and piled on one place
    (``tools.decoder_sampling_locations``), and at the encoder's (Q 22,323,
    P 4) at batch 2 and 4, with locations over the whole map, with the
    encoder's own (noise of 0.5 pixels) and with those scattered by 4
    pixels.  At the decoders' shapes K4 takes its lists route: its d_value
    must be the same bits from call to call and equal to
    ``msda_backward_rows_plain``, the call may launch nothing but the lists
    kernel (no fill, no query-major kernel) and take no more memory than
    its outputs; each prints its launches a call.  The encoder's kernel
    time includes zeroing d_value.  Returns the row of the pretrain step's
    costliest launch: the encoder's own locations at batch 4."""
    from demf_tpu_torch.ops import msda
    from demf_tpu_torch.tools import (DECODER_LOCATIONS, bound_ms, call_bytes,
                                      decoder_sampling_locations,
                                      device_kernels,
                                      encoder_sampling_locations, time_ms)
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    rows = {}
    cases = [(b, q, p, where) for b, q, p in ((16, 256, 2), (4, 300, 4))
             for where in DECODER_LOCATIONS]
    cases += [(b, s, 4, noise) for b in (2, 4) for noise in (None, 0.5, 4.0)]
    for b, q, p, where in cases:
        value = torch.from_numpy(
            rng.randn(b, s, 8, 32).astype(np.float32)).to(dev)
        if q != s:
            locs = decoder_sampling_locations(shapes, b, q, 8, p, dev, where,
                                              seed=b)
            where = f'{where} locations'
        elif where is None:
            locs = torch.from_numpy(rng.uniform(
                -0.1, 1.1, (b, q, 8, 4, p, 2)).astype(np.float32)).to(dev)
            where = 'locations over the whole map'
        else:
            locs = encoder_sampling_locations(shapes, b, 8, p, dev,
                                              jitter=where)
            where = f"the encoder's own locations, noise {where} px"
        aw = torch.from_numpy(rng.rand(b, q, 8, 4 * p).astype(np.float32))
        aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p).to(dev)
        grad = torch.from_numpy(
            rng.randn(b, q, 256).astype(np.float32)).to(dev)

        def kernel():
            return msda.msda_backward_cuda(value, shapes, locs, aw, grad)

        def plain():
            ins = [t.detach().requires_grad_() for t in (value, locs, aw)]
            out = msda.msda_plain(ins[0], shapes, ins[1], ins[2])
            return torch.autograd.grad(out, ins, grad)

        got = kernel()
        errs, bounds = [], []
        for g, w in zip(got, plain()):
            errs.append((g - w).abs().max().item())
            bounds.append(1e-5 * w.abs().max().item())
        ms = time_ms(kernel, 10)
        plain_ms = time_ms(plain, 2)
        # a sample and channel: 4 corners, each an add into d_value and a
        # product into d_aw and into both halves of d_loc
        least, by = bound_ms(
            30 * aw.numel() * 32,
            msda_bytes(shapes, value, locs, aw, backward=True))
        route, lists_ok = '', True
        if q != s:
            # the lists route: d_value the same bits call after call and
            # equal to the plain row order's, no fill and no query-major
            # kernel, and no memory beyond the outputs (the lists stay in
            # shared memory)
            again = kernel()[0]
            rows_plain = msda.msda_backward_rows_plain(value, shapes, locs,
                                                       aw, grad)
            same, plain_order = (torch.equal(got[0], again),
                                 torch.equal(got[0], rows_plain))
            del again, rows_plain
            lists = msda.msda_rows_scratch_bytes(b, s, q, 8, 4, p,
                                                 torch.float32)
            # (1 MiB for the allocator's rounding of the three blocks)
            allowed = ((value.numel() + locs.numel() + aw.numel()) * 4 +
                       lists + 2 ** 20)
            taken = call_bytes(kernel)
            found = device_kernels(kernel)
            launches = round(sum(n for n, _ in found.values()))
            route = (f'; lists route: d_value the same bits twice: {same}, '
                     f'equal to msda_backward_rows_plain: {plain_order}, '
                     f'memory a call {taken / 2 ** 20:.1f} MiB (outputs and '
                     f'entry lists {allowed / 2 ** 20:.1f} MiB), the kernel '
                     f'at {least / ms:.1%} of its bound; launches a call '
                     f'{launches}: ' + ', '.join(
                         f'{k} {t:.4f} ms' for k, (_, t) in found.items()))
            lists_ok = (same and plain_order and taken <= allowed and
                        list(found) == ['msda_backward_lists_kernel'] and
                        launches == 1)
        del got
        print(f'K4 msda_backward ({b}, Q {q}, heads 8, hd 32, L 4, P {p}, '
              f'sum_HW {s}, {where}): max_abs_err d_value / d_loc / d_aw '
              f'{errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bounds '
              f'{bounds[0]:.3e} / {bounds[1]:.3e} / {bounds[2]:.3e}), '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, least '
              f'{least:.4f} ms ({by}){route}', flush=True)
        if not lists_ok:
            raise AssertionError(
                'K4\'s lists route: d_value differs between calls or from '
                'the plain row order, or the call launches other kernels or '
                'takes more memory than its outputs and lists')
        if not all(e <= bd for e, bd in zip(errs, bounds)):
            raise AssertionError('MSDA backward kernel disagrees with plain')
        rows[b, q, where] = kernel_row(max(errs), ms, plain_ms, least, by)
        del value, locs, aw, grad
        torch.cuda.empty_cache()
    return rows[4, s, "the encoder's own locations, noise 0.5 px"]


# K3 / K4 on a bf16 value: against the plain version in bf16 an output may
# land one bf16 step apart where the two float32 sums straddle a rounding
# boundary (2^-7 of the largest); against the float32 kernel on the same
# rounded inputs each output is that sum rounded once (2^-8 of itself, plus
# 1e-5 of the largest for the order of the float32 sums).  d_loc and d_aw
# stay float32: 1e-5 of the largest.
BF16_STEP = 2.0 ** -7
BF16_HALF_STEP = 2.0 ** -8


def check_msda_bf16(dev, rng):
    """K3 and K4 on a bf16 value at the shapes of this slice's paths: the
    encoder at batch 2 (a request) and 4 (the pretrain step) on its own
    locations, the stage-2 decoder (batch 16, Q 256, P 2) and the pretrain
    decoder (batch 4, Q 300, P 4); each against the plain version in bf16
    and against the float32 kernel on the same inputs rounded to bf16,
    timed beside the plain version and the bound with the value's bytes at
    2 a number.  At the decoders' shapes K4 takes its row-owner route: its
    d_value must be the same bits from call to call and equal to
    ``msda_backward_rows_plain``, and the call may run no rounding pass
    and take no more memory than its outputs and entry lists.  Each
    prints its launches a call.  Returns the rows of K3 at the request's
    encoder shape and of K4 at the pretrain step's."""
    from demf_tpu_torch.ops import msda
    from demf_tpu_torch.tools import (bf16_err, bound_ms, call_bytes,
                                      device_kernels,
                                      encoder_sampling_locations, time_ms)
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    rows = {}
    for b, q, p in ((2, s, 4), (4, s, 4), (16, 256, 2), (4, 300, 4)):
        value = torch.from_numpy(rng.randn(b, s, 8, 32).astype(
            np.float32)).to(dev).bfloat16()
        if q == s:
            locs = encoder_sampling_locations(shapes, b, 8, p, dev)
            where = "the encoder's own locations"
        else:
            locs = torch.from_numpy(rng.uniform(
                -0.1, 1.1, (b, q, 8, 4, p, 2)).astype(np.float32)).to(dev)
            where = 'locations over the whole map'
        aw = torch.from_numpy(rng.rand(b, q, 8, 4 * p).astype(np.float32))
        aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p).to(dev)
        grad = torch.from_numpy(rng.randn(b, q, 256).astype(
            np.float32)).to(dev).bfloat16()
        shape = f'({b}, Q {q}, heads 8, hd 32, L 4, P {p}, {where})'

        got = msda.msda_cuda(value, shapes, locs, aw)
        errs = [bf16_err(got, msda.msda_plain(value, shapes, locs, aw),
                          0.0, BF16_STEP),
                bf16_err(got, msda.msda_cuda(value.float(), shapes, locs,
                                              aw), BF16_HALF_STEP, 1e-5)]
        ms = time_ms(lambda: msda.msda_cuda(value, shapes, locs, aw), 10)
        plain_ms = time_ms(lambda: msda.msda_plain(value, shapes, locs, aw),
                           3)
        least, by = bound_ms(10 * aw.numel() * 32,
                             msda_bytes(shapes, value, locs, aw))
        print(f'K3 msda bf16 {shape}: vs plain bf16 {errs[0][0]:.3e} (bound '
              f'{errs[0][1]:.3e}), vs the f32 kernel on the rounded inputs '
              f'{errs[1][0]:.3e} (bound {errs[1][1]:.3e}), kernel {ms:.4f} '
              f'ms, plain {plain_ms:.4f} ms, least {least:.4f} ms ({by}, '
              f'value at 2 bytes)', flush=True)
        if not all(e <= bd for e, bd in errs):
            raise AssertionError('MSDA bf16 kernel disagrees')
        rows['msda', b, q] = kernel_row(errs[0][0], ms, plain_ms, least, by)

        def kernel():
            return msda.msda_backward_cuda(value, shapes, locs, aw, grad)

        def plain():
            ins = [t.detach().requires_grad_() for t in (value, locs, aw)]
            out = msda.msda_plain(ins[0], shapes, ins[1], ins[2])
            return torch.autograd.grad(out, ins, grad)

        got = kernel()
        ref = msda.msda_backward_cuda(value.float(), shapes, locs, aw,
                                      grad.float())
        want = plain()
        if [t.dtype for t in got] != [torch.bfloat16, torch.float32,
                                      torch.float32]:
            raise AssertionError('K4 bf16 returned other dtypes')
        errs = [bf16_err(got[0], want[0], 0.0, BF16_STEP),
                bf16_err(got[0], ref[0], BF16_HALF_STEP, 1e-5)]
        errs += [bf16_err(g, w, 0.0, 1e-5)
                 for g, w in zip(got[1:] + got[1:], want[1:] + ref[1:])]
        del ref, want
        ms = time_ms(kernel, 10)
        plain_ms = time_ms(plain, 2)
        least, by = bound_ms(30 * aw.numel() * 32, msda_bytes(
            shapes, value, locs, aw, backward=True))
        found = device_kernels(kernel)
        launches = round(sum(n for n, _ in found.values()))
        route = ''
        if q != s:
            # the row-owner route: d_value the same bits call after call and
            # equal to the plain row order's, no rounding pass, and no
            # float32 buffer of the value's size: the call takes its
            # outputs and the entry lists
            again = kernel()[0]
            rows_plain = msda.msda_backward_rows_plain(value, shapes, locs,
                                                       aw, grad)
            same, plain_order = (torch.equal(got[0], again),
                                 torch.equal(got[0], rows_plain))
            del again, rows_plain
            lists = msda.msda_rows_scratch_bytes(b, s, q, 8, 4, p,
                                                 torch.bfloat16)
            # (1 MiB for the allocator's rounding of the four blocks)
            allowed = (value.numel() * 2 + (locs.numel() + aw.numel()) * 4 +
                       lists + 2 ** 20)
            taken = call_bytes(kernel)
            route = (f'; row-owner route: d_value the same bits twice: '
                     f'{same}, equal to msda_backward_rows_plain: '
                     f'{plain_order}, memory a call {taken / 2 ** 20:.1f} MiB'
                     f' (outputs and entry lists {allowed / 2 ** 20:.1f} MiB;'
                     f' a float32 plane {value.numel() * 4 / 2 ** 20:.1f} '
                     f'MiB)')
            if not (same and plain_order) or taken > allowed or any(
                    'round_to_bf16' in n for n in found):
                raise AssertionError(
                    'K4 bf16\'s row-owner route: d_value differs between '
                    'calls or from the plain row order, or the call rounds '
                    'a float32 plane or takes more memory than its outputs '
                    'and lists')
        print(f'K4 msda_backward bf16 {shape}: d_value vs plain bf16 '
              f'{errs[0][0]:.3e} (bound {errs[0][1]:.3e}), vs the f32 kernel '
              f'{errs[1][0]:.3e} (bound {errs[1][1]:.3e}); d_loc / d_aw vs '
              f'plain {errs[2][0]:.3e} / {errs[3][0]:.3e}, vs f32 '
              f'{errs[4][0]:.3e} / {errs[5][0]:.3e}; kernel {ms:.4f} ms, '
              f'plain {plain_ms:.4f} ms, least {least:.4f} ms ({by}, value '
              f'at 2 bytes), the kernel at {least / ms:.1%} of it; launches a '
              f'call {launches}: {", ".join(found)}{route}', flush=True)
        if not all(e <= bd for e, bd in errs):
            raise AssertionError('MSDA backward bf16 kernel disagrees')
        rows['msda_backward', b, q] = kernel_row(
            max(errs[0][0], errs[2][0], errs[3][0]), ms, plain_ms, least, by)
        del value, locs, aw, grad, got
        torch.cuda.empty_cache()
    return rows['msda', 2, s], rows['msda_backward', 4, s]


def check_quad_route(dev, rng):
    """The quad-plane route (K5 gather + K6 fold, f32 plane) against K3 at
    the encoder's shape, with samples clamped at and beyond the edges."""
    from demf_tpu_torch.ops import msda, msda_quad
    from demf_tpu_torch.tools import max_err, time_ms
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    b, q = 2, s
    value = torch.from_numpy(rng.randn(b, s, 8, 32).astype(np.float32)).to(dev)
    locs = torch.from_numpy(rng.uniform(
        -0.1, 1.1, (b, q, 8, 4, 4, 2)).astype(np.float32)).to(dev)
    aw = torch.from_numpy(rng.rand(b, q, 8, 16).astype(np.float32))
    aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, 4).to(dev)

    def quad():
        return msda_quad.msda_quad_forward(value, shapes, locs, aw)

    def k3():
        return msda.msda_cuda(value, shapes, locs, aw)

    err, bound = max_err(quad(), k3())
    ms = time_ms(quad, 3)
    k3_ms = time_ms(k3, 10)
    print(f'quad route (K5 + K6, f32) vs K3, encoder shape ({b}, Q {q}, '
          f'heads 8, hd 32, L 4, P 4, sum_HW {s}): max_abs_err {err:.3e} '
          f'(bound {bound:.3e}), quad route {ms:.4f} ms, K3 {k3_ms:.4f} ms',
          flush=True)
    if not err <= bound:
        raise AssertionError('the quad-plane route disagrees with K3')


def run_probes(dev, rng, kernels):
    """The probes' entry points and the quad route, with every launch
    count set to 0 first.  Returns the K5-K7 rows of the kernel table and
    their launches."""
    from demf_tpu_torch.tools import (bench_gather_kernel, bench_msda_fold,
                                      bench_msda_matmul)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    gather = bench_gather_kernel.main([])
    mform = bench_msda_matmul.main([])['lvl0']
    fold = bench_msda_fold.main([])
    check_quad_route(dev, rng)
    launches = {n: kernels[n].launches for n in PROBE_KERNELS}
    print(f'probes: {time.perf_counter() - t0:.2f} s, launches {launches}')
    missing = [n for n, count in launches.items() if not count]
    if missing:
        raise AssertionError(f'the probes never launched {missing}')
    torch.cuda.empty_cache()
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    measured = {n: kernel_row(*(r[key] for key in keys)) for n, r in (
        ('gather_rows', gather), ('msda_fold', fold),
        ('mform_sample', mform))}
    return measured, launches


class plain_ops:
    """Route the model's FPS, MSDA, 2D NMS and RoIAlign calls to their plain
    versions (the kernel ball query stays: its picks are checked on their
    own above; so do K8 and K9, equal to theirs bit for bit)."""

    def __enter__(self):
        from demf_tpu_torch.models import (pointnet2, rpn_roi, transformer,
                                           vote_head)
        from demf_tpu_torch.ops import msda, nms2d, roi_align, sampling
        fps = sampling.furthest_point_sample_plain
        self.saved = [(pointnet2, 'furthest_point_sample'),
                      (vote_head, 'furthest_point_sample'),
                      (transformer, 'multi_scale_deformable_attention'),
                      (rpn_roi, 'batched_nms_2d'),
                      (rpn_roi, 'pyramid_roi_align')]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.saved]
        pointnet2.furthest_point_sample = fps
        vote_head.furthest_point_sample = fps
        transformer.multi_scale_deformable_attention = msda.msda_plain

        def nms_plain(boxes, scores, idxs, thresh, valid=None):
            if valid is None:
                valid = torch.ones_like(scores, dtype=torch.bool)
            return nms2d.batched_nms_2d_plain(boxes, scores, idxs, thresh,
                                              valid)

        rpn_roi.batched_nms_2d = nms_plain
        rpn_roi.pyramid_roi_align = roi_align.pyramid_roi_align_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def with_size_prior(model):
    """A DeMF model's prediction stages started at the coder's mean class
    size (``conv_reg.bias[3:6]``): a fresh model starts its sizes at 0, as
    the JAX package's does, and boxes of no size hold no points, so K9
    would pass none to K8.  Applied here, not by any config or entry."""
    head = model.pts_bbox_head
    mean = torch.as_tensor(head.coder.mean_sizes.mean(0), dtype=torch.float32)
    with torch.no_grad():
        for i in range(len(head.decoder) + 1):
            getattr(head, f'conv_pred{i}').conv_reg.bias[3:6] = mean
    return model


def check_reference(model, dev):
    """Full-width model, small input: kernel path vs plain path."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    batch = batch_to_device(zoo.synth_demf_batch(
        2, p=4096, hw=(256, 352), valid_hw=(240, 336), seed=7), dev)
    with torch.inference_mode():
        got = model(batch)['decode_res_all']
        with plain_ops():
            want = model(batch)['decode_res_all']
    worst = 0.0
    for stage, (g, w) in enumerate(zip(got, want)):
        for key in ('center', 'size', 'dir_class', 'dir_res_norm',
                    'obj_scores', 'sem_scores'):
            scale = max(w[key].abs().max().item(), 1e-3)
            worst = max(worst, (g[key] - w[key]).abs().max().item() / scale)
            if not torch.isfinite(g[key]).all():
                raise AssertionError(f'non-finite {key} at stage {stage}')
    print(f'reference: full-width model at 4096 points, 256x352: kernel '
          f'path vs plain path, max rel err {worst:.3e} (bound 2e-3)')
    if not worst < 2e-3:
        raise AssertionError('kernel path disagrees with the plain path')


POST_PROCESSING = 'post-processing'


class post_processing_range:
    """Run ``multiclass_nms_3d`` (what ``get_bboxes`` does after the
    decoder, or after a vote head) inside a profiler range of its own."""

    def __enter__(self):
        from torch.profiler import record_function
        from demf_tpu_torch.models import demf_head, vote_head
        self.fn = fn = vote_head.multiclass_nms_3d

        def ranged(*args, **kwargs):
            with record_function(POST_PROCESSING):
                return fn(*args, **kwargs)

        demf_head.multiclass_nms_3d = vote_head.multiclass_nms_3d = ranged
        return self

    def __exit__(self, *exc):
        from demf_tpu_torch.models import demf_head, vote_head
        demf_head.multiclass_nms_3d = vote_head.multiclass_nms_3d = self.fn


def device_ms_launched_in(prof, name):
    """Device ms of the kernels whose launch (the CUDA runtime call with
    their correlation id) lies in the host range ``name``: the port's
    kernels launch through ctypes, outside any aten op."""
    from torch.autograd import DeviceType
    events = prof.events()
    ranges = [e.time_range for e in events
              if e.name == name and e.device_type == DeviceType.CPU]
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith('cu')}
    us = sum(e.time_range.elapsed_us() for e in events
             if e.device_type == DeviceType.CUDA and e.name != name and any(
                 r.start <= calls.get(e.id, -1.0) < r.end for r in ranges))
    return us / 1e3, len(ranges)


def profile_request(eval_step, batch):
    """One more request under torch.profiler (after three untraced, timed
    on the host clock: the median is the untraced time; a single one was
    once 7 times the others): the device time of the port's kernels on the
    model's own inputs, of the post-processing, and the device's busy
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    with post_processing_range(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key != POST_PROCESSING]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ours = []
    for marker in ('fps_kernel', 'ball_query_kernel', 'msda_forward_kernel',
                   'nms3d_kernel', 'box_count_kernel', 'nms2d_',
                   'roi_align_kernel'):
        hits = [e for e in events if marker in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        ours.append(f'{marker} {ms:.3f} ms in '
                    f'{sum(e.count for e in hits)} launches')
    post_ms, ranges = device_ms_launched_in(prof, POST_PROCESSING)
    if ranges != 1:
        raise AssertionError(f'{ranges} post-processing ranges in a request')
    print(f'profiled request of batch {batch["points"].shape[0]}: untraced '
          f'{wall_ms:.3f} ms (host clock, median of ' +
          ' / '.join(f'{w:.3f}' for w in walls) + f'), device kernels '
          f'{busy_ms:.3f} ms, '
          f'busy share {busy_ms / wall_ms:.1%}; post-processing '
          f'(multiclass_nms_3d) {post_ms:.3f} ms on the device; ' +
          '; '.join(ours))


def train_cfg_without_dropout():
    """configs/demf/demf_votenet.py with every decoder dropout rate at 0."""
    from demf_tpu_torch import zoo
    cfg = copy.deepcopy(zoo.load_model_cfg('demf/demf_votenet.py').model)
    tl = cfg['pts_bbox_head']['decoder']['transformerlayers']
    tl['ffn_dropout'] = 0.0
    tl['attn_cfgs'] = [dict(c, dropout=0.0) for c in tl['attn_cfgs']]
    return cfg


def check_train_reference(dev):
    """Full-width model, small input, dropout off: one forward + loss +
    backward on the kernel path vs the plain path (two copies of the same
    weights).  A gradient that is rounding noise on the plain side (below
    1e-6 of the largest: biases that feed a train-mode BatchNorm) must be
    noise on the kernel side too."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, compute_image_features
    model = zoo.build_detector(train_cfg_without_dropout(), dev, seed=1)
    batch = zoo.synth_demf_batch(2, p=4096, g=64, hw=(256, 352),
                                 valid_hw=(240, 336), seed=7)
    batch['gt_bboxes_3d'][..., 3:6] *= 3     # proposals inside GT boxes
    batch = batch_to_device(batch, dev)
    batch['img_features'] = compute_image_features(model, batch)
    del batch['img']
    plain_model = copy.deepcopy(model)

    def loss_and_grads(m):
        m.train()
        results = m(batch, generator=torch.Generator(dev).manual_seed(0))
        losses = m.loss(results, batch)
        sum(losses.values()).backward()
        return ({k: v.detach() for k, v in losses.items()},
                {n: p.grad for n, p in m.named_parameters()
                 if p.grad is not None})

    got_l, got_g = loss_and_grads(model)
    with plain_ops():
        want_l, want_g = loss_and_grads(plain_model)
    loss_err = max(abs(got_l[k].item() - w.item()) / max(abs(w.item()), 1e-6)
                   for k, w in want_l.items())
    largest = max(w.abs().max().item() for w in want_g.values())
    grad_err = 0.0
    if set(got_g) != set(want_g):
        raise AssertionError('kernel and plain paths train other tensors')
    for name, w in want_g.items():
        scale = w.abs().max().item()
        err = (got_g[name] - w).abs().max().item()
        if scale < 1e-6 * largest:
            if got_g[name].abs().max().item() >= 1e-6 * largest:
                raise AssertionError(f'{name}: gradient above noise')
            continue
        grad_err = max(grad_err, err / scale)
    terms = ', '.join(f'{k} {v.item():.5f}' for k, v in want_l.items())
    print(f'training reference: full-width model at 4096 points, 256x352, '
          f'dropout off: kernel path vs plain path, losses max rel err '
          f'{loss_err:.3e} (bound 1e-4), gradients max err / tensor max '
          f'{grad_err:.3e} (bound 1e-3) over {len(want_g)} tensors; '
          f'plain losses: {terms}')
    if not (loss_err < 1e-4 and grad_err < 1e-3):
        raise AssertionError('training kernel path disagrees with plain')


def run_training_path(dev, kernels):
    """The stage-2 step at full width, K18 checked on the first step's
    own call; returns the launches of the steps, the first step's metrics
    and K18's row."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, compute_image_features
    t0 = time.perf_counter()
    model, _, step = zoo.build_trainer('demf/demf_votenet.py', dev, seed=0)
    with_size_prior(model)
    print(f'training: DeMF-VoteNet full width, '
          f'{sum(p.numel() for p in model.parameters() if p.requires_grad)}'
          f' trained parameters, built in {time.perf_counter() - t0:.2f} s')
    batch = batch_to_device(zoo.synth_demf_batch(**TRAIN_BATCH), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch['img_features'] = compute_image_features(model, batch)
    torch.cuda.synchronize()
    fill = time.perf_counter() - t0
    del batch['img']
    print(f'training: feature cache filled for {TRAIN_BATCH["b"]} scenes in '
          f'{fill * 1e3:.3f} ms (host clock; first run of the image branch '
          f'at this shape)')
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    for i in range(TRAIN_STEPS):
        start = {n: k.launches for n, k in kernels.items()}
        with recorded_calls() if i == 0 else \
                contextlib.nullcontext() as kept:
            t0 = time.perf_counter()
            metrics = step(batch, generator)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if i == 0:
            target_calls = kept['vote_targets']
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_STEP:
            raise AssertionError(f'step {i} launched {launched}, expected '
                                 f'{LAUNCHES_PER_STEP}')
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f'step {i}: non-finite {bad}')
        if i == 0:
            first = {k: v.item() for k, v in metrics.items()}
        terms = ', '.join(f'{k} {v.item():.5f}' for k, v in metrics.items())
        STEP_MS.append(seconds * 1e3)
        print(f'train step {i}: {seconds * 1e3:.3f} ms (host clock), '
              f'{TRAIN_BATCH["b"] / seconds:.3f} scenes/s, launches '
              f'{launched}; {terms}')
    launches = {n: k.launches for n, k in kernels.items()}
    print(f'training: peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB over '
          f'{TRAIN_STEPS} steps')
    moved = frozen = 0
    patterns = model.frozen_param_patterns()
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if any(pat in name for pat in patterns):
            if not same:
                raise AssertionError(f'frozen {name} changed')
            frozen += 1
        elif same and (p.grad is None or p.grad.any()):
            raise AssertionError(f'{name} did not move')
        else:
            moved += not same
    print(f'training: {frozen} frozen image-branch tensors unchanged, '
          f'{moved} trained tensors moved')
    compare_devpipe_step(model, step, batch, generator, kernels)
    return launches, first, check_vote_targets(target_calls)


def check_vote_targets(calls):
    """K18 on a DeMF-VoteNet train step's own call (its points, GT boxes,
    validity and gt_per_seed): the targets and masks equal to
    ``vote_targets_plain``'s (the JAX package's expressions on the card)
    and to the model's entry ``_vote_targets``'s bit for bit, the same bits
    on a second call; timed through its wrapper and on the device beside
    the plain version and its bound (``tools.vote_target_bound``: the
    (point, valid box) tests at half the float32 rate, or the points read
    and the targets and masks written).  No one PyTorch call computes the
    targets."""
    from demf_tpu_torch.core.boxes import points_in_boxes
    from demf_tpu_torch.models import target_assign
    from demf_tpu_torch.ops import vote_targets as vt
    from demf_tpu_torch.tools import (device_kernels, same_bits, time_ms,
                                      vote_target_bound)
    if len(calls) != 1:
        raise AssertionError(f'K18: {len(calls)} calls a step')
    points, boxes, valid, per_seed, eps = calls[0]
    got, masks = vt.vote_targets_cuda(points, boxes, valid, per_seed, eps)
    again = vt.vote_targets_cuda(points, boxes, valid, per_seed, eps)
    want, want_m = vt.vote_targets_plain(points, boxes, valid, per_seed, eps)
    entry = target_assign._vote_targets(points, boxes, valid, per_seed)
    ok = (same_bits(got, want) and torch.equal(masks, want_m) and
          same_bits(again[0], got) and torch.equal(again[1], masks) and
          same_bits(entry[0], got) and torch.equal(entry[1], masks))
    b, p, _ = points.shape
    g = boxes.shape[1]
    hits = (points_in_boxes(points, boxes, eps) & valid[:, None]).sum(-1)
    print(f'K18 vote_targets on a train step\'s call: {b} scenes x {p} '
          f'points x {g} GT slots ({int(valid.sum())} valid), gt_per_seed '
          f'{per_seed}; points in {list(range(per_seed))} / >={per_seed} '
          f'boxes: {[int((hits == k).sum()) for k in range(per_seed)]} / '
          f'{int((hits >= per_seed).sum())}; targets and masks the plain '
          f'version\'s bits: {ok}', flush=True)
    if not ok:
        raise AssertionError('K18 differs from its plain version')
    ms = time_ms(lambda: vt.vote_targets_cuda(points, boxes, valid,
                                              per_seed, eps), 20)
    device = device_kernels(lambda: vt.vote_targets_cuda(
        points, boxes, valid, per_seed, eps))
    device_ms = sum(t for _, t in device.values())
    plain_ms = time_ms(lambda: vt.vote_targets_plain(points, boxes, valid,
                                                     per_seed, eps), 5)
    least, by = vote_target_bound(points, boxes, valid, per_seed)
    print(f'K18 vote_targets: kernel {ms:.4f} ms through its wrapper, '
          f'{device_ms:.4f} on the device in '
          f'{sum(n for n, _ in device.values()):g} launch(es), plain '
          f'{plain_ms:.4f} ms, bound {least:.6f} ms ({by}; {least / ms:.1%} '
          f'of the wrapper\'s, {least / device_ms:.1%} of the device\'s)',
          flush=True)
    return kernel_row(0.0, ms, plain_ms, least, by)


def stage_errors(got, want):
    """Largest |got - want| / max |want| over the stage predictions."""
    worst = 0.0
    for g, w in zip(got['decode_res_all'], want['decode_res_all']):
        for key in ('center', 'size', 'dir_class', 'dir_res_norm',
                    'obj_scores', 'sem_scores'):
            if not torch.isfinite(g[key]).all():
                raise AssertionError(f'non-finite {key}')
            scale = max(w[key].abs().max().item(), 1e-3)
            worst = max(worst, (g[key].float() - w[key]).abs().max().item() /
                        scale)
    return worst


def weight_copy_ms(model, dtype, inference):
    """Host ms of the bf16 weight copies that one call under the policy
    takes (``policy_weights``), as a step or a request takes them: made
    anew (after a ``load_state_dict``, which changes every parameter's
    version, as every call made them before copies were kept), then as
    kept; and the count of floating parameters cast anew on every call."""
    from demf_tpu_torch.utils.precision import policy_weights
    model.load_state_dict(model.state_dict())
    mode = torch.inference_mode if inference else contextlib.nullcontext
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode():
            policy_weights(model, dtype)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    floating = [p for p in model.parameters() if p.is_floating_point()]
    cast = 0 if inference else sum(p.requires_grad for p in floating)
    return times, cast, len(floating)


def run_serving_bf16(model, dev, kernels):
    """Requests of batch 2 through ``make_eval_step`` under the bf16 policy
    (``bf16=True``): latency, peak memory, launches, one profiled; the
    stage predictions against the float32 request's within
    ``SERVE_BF16_BOUND`` of each tensor's largest, and the detections
    finite.  Returns the launches of the timed requests."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    from demf_tpu_torch.utils.precision import (cast_batch, cast_floating,
                                                policy_call,
                                                resolve_compute_dtype)
    dtype = resolve_compute_dtype(dict(bf16=True))
    eval_step = make_eval_step(model, dtype)
    batch = batch_to_device(zoo.synth_demf_batch(
        2, p=20000, hw=(800, 1344), valid_hw=(784, 1312), seed=5), dev)
    eval_step(batch)                    # the first request at this dtype
    for k in kernels.values():
        k.launches = 0
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = eval_step(batch)
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        for key in ('boxes_3d', 'scores_3d'):
            if det[key].dtype != torch.float32 or \
                    not torch.isfinite(det[key]).all():
                raise AssertionError(f'bf16 request: {key} not finite f32')
        print(f'bf16 request {i}: latency {latency:.3f} ms (host clock, '
              f'batch 2, 20000 points, 800x1344), '
              f'{int(det["valid"].sum())} valid detections, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB',
              flush=True)
    launches = {n: k.launches for n, k in kernels.items()}
    expected = {n: 2 * c for n, c in LAUNCHES_PER_REQUEST_BF16.items()}
    if launches != expected:
        raise AssertionError(f'bf16 requests launched {launches}, expected '
                             f'{expected}')
    profile_request(eval_step, batch)
    with torch.inference_mode():
        got = cast_floating(policy_call(model, dtype, cast_batch(
            batch, dtype)), torch.float32)
        want = model(batch)
    worst = stage_errors(got, want)
    print(f'bf16 request: stage predictions vs the float32 request, max '
          f'err / tensor max {worst:.3e} (bound {SERVE_BF16_BOUND}); '
          f'launches {launches}', flush=True)
    if not worst < SERVE_BF16_BOUND:
        raise AssertionError('bf16 request strays from float32')
    (made, kept), _, n = weight_copy_ms(model, dtype, inference=True)
    print(f'bf16 request weight copies: {made:.3f} ms made anew, {kept:.3f} '
          f'ms kept (host clock, {n} parameters)', flush=True)
    return launches


def run_training_bf16(dev, kernels, fp32_first):
    """The stage-2 step at full width under the bf16 policy, from the
    weights, batch and dropout draws of the float32 training path: its
    first step's losses within 0.2 of the float32 first step's (the JAX
    package's bound), then step time and peak memory; the master weights,
    the optimizer state and the BatchNorm statistics stay float32.
    Returns the launches of the steps."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, compute_image_features
    cfg = copy.deepcopy(zoo.load_model_cfg('demf/demf_votenet.py'))
    cfg.bf16 = True
    model, optimizer, step = zoo.build_trainer(cfg, dev, seed=0)
    with_size_prior(model)
    if step.compute_dtype != torch.bfloat16:
        raise AssertionError('bf16=True did not select the policy')
    batch = batch_to_device(zoo.synth_demf_batch(**TRAIN_BATCH), dev)
    batch['img_features'] = compute_image_features(model, batch)
    del batch['img']
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    for i in range(TRAIN_STEPS - 1):
        start = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_STEP_BF16:
            raise AssertionError(f'bf16 step {i} launched {launched}')
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f'bf16 step {i}: non-finite {bad}')
        if i == 0:
            losses_against({k: float(v) for k, v in metrics.items()},
                           fp32_first, 'bf16 train')
        print(f'bf16 train step {i}: {seconds * 1e3:.3f} ms (host clock), '
              f'{TRAIN_BATCH["b"] / seconds:.3f} scenes/s, launches '
              f'{launched}; loss {metrics["loss"].item():.5f}', flush=True)
    launches = {n: k.launches for n, k in kernels.items()}
    print(f'bf16 training: peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB over '
          f'{TRAIN_STEPS - 1} steps')
    masters_in_float32(model, optimizer, 'bf16 training')
    (made, kept), cast, n = weight_copy_ms(model, step.compute_dtype,
                                          inference=False)
    print(f'bf16 step weight copies: {made:.3f} ms all made anew, {kept:.3f} '
          f'ms with the frozen ones kept (host clock; {cast} of {n} '
          f'parameters cast every step)', flush=True)
    return launches


def run_pretrain_bf16(dev, kernels):
    """The stage-1 pretrain step at full width under the bf16 policy:
    step time, peak memory, K4's device ms in a profiled step."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    cfg = pretrain_cfg()
    cfg.bf16 = True
    model, _, step = zoo.build_trainer(cfg, dev, seed=0)
    batch = batch_to_device(zoo.synth_detr2d_batch(seed=0, **PRETRAIN_BATCH),
                            dev)
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    for i in range(PRETRAIN_STEPS - 1):
        start = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_PRETRAIN_STEP_BF16:
            raise AssertionError(f'bf16 pretrain step {i} launched '
                                 f'{launched}')
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'bf16 pretrain step {i}: non-finite')
        print(f'bf16 pretrain step {i}: {seconds * 1e3:.3f} ms (host '
              f'clock), {PRETRAIN_BATCH["b"] / seconds:.3f} images/s; loss '
              f'{metrics["loss"].item():.5f}', flush=True)
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    found = kernels_a_call(lambda: step(batch, generator), dict(
        k4=('msda_backward', 'round_to_bf16'), k3=('msda_forward',)), runs=2)
    (k4_ms, k4_n), (k3_ms, k3_n), (busy_ms, _) = (found[k] for k in (
        'k4', 'k3', 'all'))
    print(f'bf16 pretrain: peak memory {peak:.1f} MiB at batch '
          f'{PRETRAIN_BATCH["b"]}; device ms a step (tools.device_kernels, '
          f'2 profiled steps): all kernels {busy_ms:.3f} ms, K4 (bf16) '
          f'{k4_ms:.3f} ms in {k4_n} launches, K3 (bf16) {k3_ms:.3f} ms in '
          f'{k3_n}', flush=True)
    del model, step, batch
    torch.cuda.empty_cache()
    return launches


def votenet_reference(dev):
    """Full-width VoteNet, 2 scenes of 20,000 points: one forward + loss +
    backward on the kernel path against the plain path (losses 1e-4,
    gradients 1e-3 of each tensor's largest)."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    model = zoo.build_detector(zoo.load_model_cfg(VOTENET_CFG).model, dev,
                               seed=1)
    batch = zoo.synth_points_batch(2, 20000, g=64, seed=7)
    batch['gt_bboxes_3d'][..., 3:6] *= 3
    batch = batch_to_device(batch, dev)
    plain_model = copy.deepcopy(model)

    def loss_and_grads(m):
        m.train()
        losses = m.loss(m(batch), batch)
        sum(losses.values()).backward()
        return ({k: v.detach() for k, v in losses.items()},
                {n: p.grad for n, p in m.named_parameters()
                 if p.grad is not None})

    got_l, got_g = loss_and_grads(model)
    with plain_ops():
        want_l, want_g = loss_and_grads(plain_model)
    loss_err = max(abs(got_l[k].item() - w.item()) / max(abs(w.item()), 1e-6)
                   for k, w in want_l.items())
    largest = max(w.abs().max().item() for w in want_g.values())
    grad_err = 0.0
    for name, w in want_g.items():
        scale = w.abs().max().item()
        if scale < 1e-6 * largest:
            if got_g[name].abs().max().item() >= 1e-6 * largest:
                raise AssertionError(f'{name}: gradient above noise')
            continue
        grad_err = max(grad_err, (got_g[name] - w).abs().max().item() / scale)
    print(f'votenet reference: full width, 2 scenes of 20000 points: kernel '
          f'path vs plain path, losses max rel err {loss_err:.3e} (bound '
          f'1e-4), gradients max err / tensor max {grad_err:.3e} (bound '
          f'1e-3) over {len(want_g)} tensors', flush=True)
    if not (set(got_g) == set(want_g) and loss_err < 1e-4 and
            grad_err < 1e-3):
        raise AssertionError('votenet kernel path disagrees with plain')


def run_votenet_path(dev, kernels):
    """VoteNet at full width: kernel path vs plain path; steps at batch
    16 x 20,000 with 64 GT slots in float32 and under the bf16 policy
    (``train --synthetic``'s trainer and batch); the same through the entry
    point in both; then the dataset path on
    ``demf_tpu_torch/configs/votenet_synthetic.py`` (train entry, an
    epoch, a checkpoint, the eval hook, the eval entry, the mAP); last,
    the standard ``VoteHead`` of ``configs/_base_/models/votenet.py``.
    Returns the launches by sub-path."""
    from demf_tpu_torch import eval as eval_entry
    from demf_tpu_torch import train as train_entry
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, latest_checkpoint
    votenet_reference(dev)
    by_path = {}
    for bf16 in (False, True):
        cfg = copy.deepcopy(zoo.load_model_cfg(VOTENET_CFG))
        if bf16:
            cfg.bf16 = True
        model, _, step = zoo.build_trainer(cfg, dev, seed=0)
        b, p, g = (VOTENET_BATCH[k] for k in 'bpg')
        batch = batch_to_device(zoo.synth_batch_for(model, p=p, seed=0), dev)
        if tuple(batch['points'].shape) != (b, p, 4) or \
                tuple(batch['gt_valid'].shape) != (b, g) or 'img' in batch:
            raise AssertionError('votenet batch of another shape')
        generator = torch.Generator(dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        times = []
        for i in range(VOTENET_STEPS):
            start = {n: k.launches for n, k in kernels.items()}
            t0 = time.perf_counter()
            metrics = step(batch, generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launched = {n: k.launches - start[n] for n, k in kernels.items()}
            if launched != LAUNCHES_PER_VOTENET_STEP:
                raise AssertionError(f'votenet step {i} launched {launched}')
            if not all(torch.isfinite(v) for v in metrics.values()):
                raise AssertionError(f'votenet step {i}: non-finite')
        name = 'bf16' if bf16 else 'f32'
        by_path[f'votenet_{name}'] = {n: k.launches
                                      for n, k in kernels.items()}
        print(f'votenet {name}: steps at batch {b} x {p} points, {g} GT: ' +
              ', '.join(f'{t * 1e3:.3f}' for t in times) + ' ms (host '
              f'clock), after the first {b / np.mean(times[1:]):.3f} '
              f'scenes/s; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; loss '
              f'{metrics["loss"].item():.5f}', flush=True)
        argv = [VOTENET_CFG, '--synthetic', '--steps', '2', '--points',
                str(p)]
        if bf16:
            argv += ['--cfg-options', 'bf16=True']
        _, out, seconds, _ = run_entry(
            train_entry.main, argv, kernels,
            {n: 2 * c for n, c in LAUNCHES_PER_VOTENET_STEP.items()})
        if out.count('Epoch [1/1]') != 2:
            raise AssertionError('the votenet entry logged no steps')
        print(f'votenet {name}: train entry --synthetic --steps 2 '
              f'{seconds:.3f} s in all', flush=True)
        del model, step, batch
        torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(root, VOTENET_DATASET_CFG)
    build_dir = os.path.join(root, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        np.random.seed(0)
        _, out, seconds, launches = run_entry(
            train_entry.main, [cfg_file, '--work-dir', work_dir], kernels,
            LAUNCHES_VOTENET_TRAIN_ENTRY)
        wait = [line for line in out.splitlines()
                if 'waiting for the loader' in line]
        if len(wait) != 1 or out.count('[eval @ epoch 1]') != 1 or \
                'image-feature cache' in out:
            raise AssertionError('the votenet train entry logged no epoch '
                                 'or eval, or filled a feature cache')
        print(f'votenet dataset path: train entry {seconds:.3f} s in all; '
              f'{wait[0].split(" - ", 1)[1]}; launches {launches}',
              flush=True)
        ckpt = latest_checkpoint(work_dir)
        out_file = os.path.join(work_dir, 'results.pkl')
        torch.cuda.reset_peak_memory_stats()
        np.random.seed(7)
        metrics, out, seconds, eval_launches = run_entry(
            eval_entry.main, [cfg_file, ckpt, '--eval', 'mAP', '--out',
                              out_file], kernels,
            LAUNCHES_VOTENET_EVAL_ENTRY)
        with open(out_file, 'rb') as f:
            results = pickle.load(f)
        if len(results) != VAL_SCENES or not all(
                np.isfinite(r['boxes_3d']).all() for r in results) or \
                not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError('votenet eval entry: results or mAP')
        print(f'votenet dataset path: eval entry {seconds:.3f} s in all, '
              f'{len(results) / seconds:.3f} scenes/s, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, '
              f'{sum(len(r["scores_3d"]) for r in results)} detections, '
              f'mAP_0.25 {metrics["mAP_0.25"]:.4f} mAP_0.50 '
              f'{metrics["mAP_0.50"]:.4f} (random weights), launches '
              f'{eval_launches}', flush=True)
    by_path['votenet_dataset'] = {n: launches[n] + eval_launches[n]
                                  for n in launches}
    check_standard_vote_head(dev)
    return by_path


def check_standard_vote_head(dev):
    """The standard VoteHead of the _base_ model, with the SUN RGB-D coder
    of mmdet3d's votenet config (the _base_ file leaves the coder to it):
    one forward, loss, backward and ``get_bboxes`` at 2 x 20,000 points."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    base = copy.deepcopy(zoo.load_model_cfg('_base_/models/votenet.py'))
    means = zoo.load_model_cfg(VOTENET_CFG).model['bbox_head'][
        'bbox_coder']['mean_sizes']
    base.model['bbox_head'].update(
        num_classes=10, bbox_coder=dict(
            type='PartialBinBasedBBoxCoder', num_dir_bins=12, num_sizes=10,
            with_rot=True, mean_sizes=means))
    model = zoo.build_detector(base.model, dev, seed=2).train()
    batch = batch_to_device(zoo.synth_points_batch(2, 20000, g=64, seed=9),
                            dev)
    results = model(batch)
    losses = model.loss(results, batch)
    sum(losses.values()).backward()
    model.eval()
    with torch.inference_mode():
        det = model.get_bboxes(model(batch), batch)
    if not all(torch.isfinite(v) for v in losses.values()) or \
            not torch.isfinite(det['boxes_3d']).all() or \
            tuple(det['boxes_3d'].shape) != (2, 2560, 7):
        raise AssertionError('standard VoteHead: non-finite or misshapen')
    print(f'standard VoteHead (configs/_base_/models/votenet.py): forward, '
          f'{len(losses)} losses ({", ".join(sorted(losses))}), backward '
          f'and get_bboxes {tuple(det["boxes_3d"].shape)} at 2 x 20000 '
          f'points, finite; {int(det["valid"].sum())} valid', flush=True)


class Tee(io.StringIO):
    """Collects what is printed and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def run_entry(main, argv, kernels, expected):
    """One entry point's ``main(argv)`` with every launch count at 0 before
    it: -> (what it returned, what it printed, seconds, launches); raises
    unless it launched each kernel the expected number of times."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    if launches != expected:
        raise AssertionError(f'{main.__module__} launched {launches}, '
                             f'expected {expected}')
    return result, tee.getvalue(), seconds, launches


def run_dataset_path(kernels):
    """dataset -> train -> checkpoint -> eval -> mAP through the entry
    points, at full width, then the eval entry again with
    ``--fuse-conv-bn --show-dir`` (``check_fused_eval``); returns the
    launches of the two entries and those of the fused eval."""
    from demf_tpu_torch import eval as eval_entry
    from demf_tpu_torch import train as train_entry
    from demf_tpu_torch.data import build_dataloader, build_dataset
    from demf_tpu_torch.engine import (latest_checkpoint, load_checkpoint,
                                       load_meta, run_dataset_inference)
    from demf_tpu_torch.utils.config import Config
    root = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(root, DATASET_CFG)
    cfg = Config.fromfile(cfg_file)
    batch = cfg.data['samples_per_gpu']

    np.random.seed(0)
    train_set = build_dataset(cfg.data['train'])
    loader = build_dataloader(train_set, samples_per_gpu=batch,
                              workers_per_gpu=cfg.data['workers_per_gpu'],
                              shuffle=True, seed=0)
    t0 = time.perf_counter()
    shapes = [(b['points'].shape, b['img'].shape) for b in loader]
    seconds = time.perf_counter() - t0
    scenes = len(shapes) * batch
    print(f'dataset path: host pipeline alone, {scenes} scenes '
          f'({cfg.data["workers_per_gpu"]} workers, batches of points '
          f'{shapes[0][0]} and images {shapes[0][1]}) in {seconds:.3f} s, '
          f'{scenes / seconds:.3f} scenes/s')
    if shapes != [TRAIN_BATCH_SHAPES] * 2:
        raise AssertionError(f'train batches of {shapes}')

    # the work dir (feature cache ~0.4 GB, checkpoint, log) goes where the
    # kernels are built: under build/ of this checkout, removed afterwards
    build_dir = os.path.join(root, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        _, out, seconds, launches = run_entry(
            train_entry.main, [cfg_file, '--work-dir', work_dir], kernels,
            LAUNCHES_TRAIN_ENTRY)
        wait = [line for line in out.splitlines()
                if 'waiting for the loader' in line]
        if len(wait) != 1 or out.count('[eval @ epoch 1]') != 1:
            raise AssertionError('the train entry logged no epoch or eval')
        print(f'dataset path: train entry {seconds:.3f} s in all; '
              f'{wait[0].split(" - ", 1)[1]}; launches {launches}')
        ckpt = latest_checkpoint(work_dir)
        meta = load_meta(ckpt)
        if meta['CLASSES'] != list(train_set.CLASSES) or meta['epoch'] != 0 \
                or 'SyntheticSUNRGBD' not in meta['config']:
            raise AssertionError(f'checkpoint meta: {sorted(meta)}')
        if os.listdir(os.path.dirname(ckpt)) != ['epoch_1.pth']:
            raise AssertionError('checkpoints were not pruned')

        out_file = os.path.join(work_dir, 'results.pkl')
        torch.cuda.reset_peak_memory_stats()
        np.random.seed(7)
        metrics, out, seconds, eval_launches = run_entry(
            eval_entry.main, [cfg_file, ckpt, '--eval', 'mAP', '--out',
                              out_file], kernels, LAUNCHES_EVAL_ENTRY)
        peak = torch.cuda.max_memory_allocated() / 2**20
        with open(out_file, 'rb') as f:
            results = pickle.load(f)
        val_set = build_dataset(cfg.data['test'])
        if len(results) != len(val_set) or len(val_set) != VAL_SCENES:
            raise AssertionError(f'{len(results)} results for '
                                 f'{len(val_set)} scenes')
        for r in results:
            if not (np.isfinite(r['boxes_3d']).all() and
                    np.isfinite(r['scores_3d']).all()):
                raise AssertionError('non-finite detections')
        if not all(np.isfinite(v) for v in metrics.values()) or \
                f"mAP_0.25: {metrics['mAP_0.25']:.4f}" not in out:
            raise AssertionError(f'mAP {metrics}')
        print(f'dataset path: eval entry {seconds:.3f} s in all, '
              f'{len(results) / seconds:.3f} scenes/s with the model\'s '
              f'build and the host pipeline in one thread, peak memory '
              f'{peak:.1f} MiB at batch {batch}, '
              f'{sum(len(r["scores_3d"]) for r in results)} detections, '
              f'mAP_0.25 {metrics["mAP_0.25"]:.4f} mAP_0.50 '
              f'{metrics["mAP_0.50"]:.4f} (random weights), launches '
              f'{eval_launches}')

        fused_launches = check_fused_eval(eval_entry, cfg_file, ckpt,
                                          results, work_dir, kernels)

        # the first result is scene 0's: the same draws, the scene alone
        from demf_tpu_torch import zoo
        model = zoo.build_detector(cfg.model, seed=0)
        load_checkpoint(ckpt, model)
        np.random.seed(7)
        alone = run_dataset_inference(model, [val_set[0]], batch_size=batch)
        top = slice(0, 10)
        if abs(len(alone[0]['scores_3d']) - len(results[0]['scores_3d'])) > \
                0.01 * len(results[0]['scores_3d']) or not np.allclose(
                    np.sort(alone[0]['scores_3d'])[::-1][top],
                    np.sort(results[0]['scores_3d'])[::-1][top], atol=1e-4):
            raise AssertionError('the first result is not scene 0')
    for n in launches:
        launches[n] += eval_launches[n]
    return launches, fused_launches


def pretrain_cfg(dropout=None, solver=None):
    """The stage-1 config; with ``dropout`` every rate of the head's
    transformer set to it, with ``solver`` the assigner's solver."""
    from demf_tpu_torch import zoo
    cfg = copy.deepcopy(zoo.load_model_cfg(PRETRAIN_CFG))
    model = cfg.model
    if dropout is not None:
        t = model['img_bbox_head']['transformer']
        enc = t['encoder']['transformerlayers']
        enc['ffn_dropout'] = dropout
        enc['attn_cfgs'] = dict(enc['attn_cfgs'], dropout=dropout)
        dec = t['decoder']['transformerlayers']
        dec['ffn_dropout'] = dropout
        dec['attn_cfgs'] = [dict(c, dropout=dropout)
                            for c in dec['attn_cfgs']]
    if solver is not None:
        model['train_cfg']['assigner']['solver'] = solver
    return cfg


def check_pretrain_reference(dev):
    """The full-width stage-1 model, dropout off, the scipy solver: one
    forward + loss + backward on the batch of the steps below (4 images of
    800x1344: 22,323 tokens and 300 decoder queries, the shapes at which
    the steps launch K3 and K4) on the kernel path against the plain path,
    from the same weights."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    model = zoo.build_detector(pretrain_cfg(0.0, 'scipy').model, dev, seed=1)
    batch = batch_to_device(zoo.synth_detr2d_batch(seed=7, **PRETRAIN_BATCH),
                            dev)
    plain_model = copy.deepcopy(model)

    def loss_and_grads(m):
        m.train()
        torch.cuda.reset_peak_memory_stats()
        losses = m.loss(m(batch), batch)
        sum(losses.values()).backward()
        return ({k: v.detach() for k, v in losses.items()},
                {n: p.grad for n, p in m.named_parameters()
                 if p.grad is not None},
                torch.cuda.max_memory_allocated() / 2**20)

    got_l, got_g, got_mib = loss_and_grads(model)
    with plain_ops():
        want_l, want_g, want_mib = loss_and_grads(plain_model)
    if set(got_g) != set(want_g) or any(
            n.startswith(('img_backbone.conv1', 'img_backbone.layer1.'))
            for n in want_g):
        raise AssertionError('kernel and plain paths train other tensors, '
                             'or the frozen stages got a gradient')
    loss_err = max(abs(got_l[k].item() - w.item()) / max(abs(w.item()), 1e-6)
                   for k, w in want_l.items())
    # a gradient that is rounding noise on the plain side (below 1e-6 of
    # the largest) must be noise on the kernel side too
    largest = max(w.abs().max().item() for w in want_g.values())
    grad_err, worst, noise = 0.0, None, []
    for name, w in want_g.items():
        scale = w.abs().max().item()
        if scale < 1e-6 * largest:
            if got_g[name].abs().max().item() >= 1e-6 * largest:
                raise AssertionError(f'{name}: gradient above noise')
            noise.append(name)
            continue
        err = (got_g[name] - w).abs().max().item() / scale
        if err > grad_err:
            grad_err, worst = err, name
    b, hw = PRETRAIN_BATCH['b'], PRETRAIN_BATCH['hw']
    print(f'pretrain reference: full-width stage-1 model, {b} images of '
          f'{hw[0]}x{hw[1]}, dropout off, scipy solver: kernel path (peak '
          f'{got_mib:.1f} MiB) vs plain path (peak {want_mib:.1f} MiB), '
          f'{len(want_l)} losses max rel err {loss_err:.3e} (bound 1e-4), '
          f'gradients max err / tensor max {grad_err:.3e} (bound 1e-3, at '
          f'{worst}) over {len(want_g) - len(noise)} tensors ({len(noise)} '
          f'at noise level: {noise[:3]}); total loss '
          f'{sum(v.item() for v in want_l.values()):.5f}', flush=True)
    if not (loss_err < 1e-4 and grad_err < 1e-3):
        raise AssertionError('pretrain kernel path disagrees with plain')


def time_solvers(model, batch, dev):
    """The one-to-one assignment of a step, (6 layers x 4 images, Q 300, G
    20), on the model's own costs: the auction on the card (its steps, and
    its time with the host's reads of the state) and scipy on the host
    (with the copy of the costs and of the result)."""
    from demf_tpu_torch.models.detr_head import _whwh, box_xyxy_to_cxcywh
    from demf_tpu_torch.ops.assignment import auction_assign, hungarian_match
    head = model.img_bbox_head
    with torch.no_grad():
        preds = model.eval()(batch)['img_preds']
        factor = _whwh(batch['img_meta']['img_shape'])
        gt = box_xyxy_to_cxcywh(batch['gt_bboxes'] / factor[:, None])
        cost = head.match_cost(preds['cls_scores'], preds['bbox_preds'], gt,
                               batch['gt_labels'], batch['gt_bboxes_valid'],
                               factor).flatten(0, 1)
    model.train()

    def clock(fn, runs=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / runs * 1e3, out

    auction_ms, (assigned, steps) = clock(lambda: auction_assign(
        cost.transpose(1, 2), return_steps=True))
    scipy_ms, optimum = clock(lambda: hungarian_match(cost))
    layers = preds['cls_scores'].shape[0]
    valid = batch['gt_bboxes_valid'].repeat(layers, 1)
    rows = torch.arange(cost.shape[0], device=dev)[:, None]
    cols = torch.arange(cost.shape[2], device=dev)[None]
    totals = [(cost[rows, a, cols] * valid).sum().item()
              for a in (assigned, optimum)]
    same = ((assigned == optimum) | ~valid).float().mean().item()
    print(f'pretrain path: assignment of {tuple(cost.shape)} costs, '
          f'{int(valid.sum())} real columns: auction {steps} steps, '
          f'{auction_ms:.3f} ms (host clock, state read every 8 steps); '
          f'scipy on the host {scipy_ms:.3f} ms with its copies; total cost '
          f'{totals[0]:.4f} against the optimum {totals[1]:.4f}, '
          f'{same:.2%} of the assignments equal', flush=True)
    if totals[0] > totals[1] * 1.001 + 1e-3:
        raise AssertionError('the auction is further from the optimum than '
                             'its bound')


def run_pretrain_path(dev, kernels):
    """The stage-1 pretrain step at full width; returns the launches of its
    steps."""
    from demf_tpu_torch import train as train_entry
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import (batch_to_device, latest_checkpoint,
                                       load_weights, make_eval_step)
    check_pretrain_reference(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, _, step = zoo.build_trainer(pretrain_cfg(), dev, seed=0)
    trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f'pretrain path: ImVoteNet_Deformdetr full width, image-only, '
          f'{sum(p.numel() for p in model.parameters())} parameters, '
          f'{trained} trained, built in {time.perf_counter() - t0:.2f} s')
    batch = batch_to_device(zoo.synth_detr2d_batch(seed=0, **PRETRAIN_BATCH),
                            dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    for i in range(PRETRAIN_STEPS):
        start = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_PRETRAIN_STEP:
            raise AssertionError(f'pretrain step {i} launched {launched}, '
                                 f'expected {LAUNCHES_PER_PRETRAIN_STEP}')
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad or len(metrics) != 6 * 3 + 2:
            raise AssertionError(f'pretrain step {i}: non-finite {bad} of '
                                 f'{len(metrics)} metrics')
        print(f'pretrain step {i}: {seconds * 1e3:.3f} ms (host clock), '
              f'{PRETRAIN_BATCH["b"] / seconds:.3f} images/s, launches '
              f'{launched}; loss {metrics["loss"].item():.5f}, grad_norm '
              f'{metrics["grad_norm"].item():.5f}')
    launches = {n: k.launches for n, k in kernels.items()}
    print(f'pretrain path: peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB over '
          f'{PRETRAIN_STEPS} steps at batch {PRETRAIN_BATCH["b"]}')
    frozen = moved = 0
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if not p.requires_grad:
            if not same or not name.startswith('img_backbone.'):
                raise AssertionError(f'frozen {name} changed')
            frozen += 1
        elif same:
            raise AssertionError(f'{name} did not move')
        else:
            moved += 1
    print(f'pretrain path: {frozen} tensors of the frozen stages unchanged, '
          f'{moved} trained tensors moved')
    time_solvers(model, batch, dev)
    del model, step, batch, before
    torch.cuda.empty_cache()

    # the same steps through the entry point, and one more under the
    # profiler: 3 + 1 untraced + 1 traced
    root = os.path.dirname(os.path.abspath(__file__))
    expected = {n: 5 * c for n, c in LAUNCHES_PER_PRETRAIN_STEP.items()}
    _, out, seconds, _ = run_entry(
        train_entry.main, [PRETRAIN_CFG, '--synthetic', '--steps', '3',
                           '--profile'], kernels, expected)
    if out.count('Epoch [1/1]') != 3 or 'profiled step' not in out or \
            'phases: forward' not in out:
        raise AssertionError('the train entry logged no steps or profile')
    print(f'pretrain path: train entry --synthetic --steps 3 --profile '
          f'{seconds:.3f} s in all')
    torch.cuda.empty_cache()

    build_dir = os.path.join(root, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        # the dataset mode at full width: 16 scenes under the unchanged 2D
        # pipeline (AutoAugment, RandomCrop, multi-scale Resize), 4 steps
        expected = {n: 4 * c for n, c in LAUNCHES_PER_PRETRAIN_STEP.items()}
        _, out, seconds, _ = run_entry(
            train_entry.main, [os.path.join(root, PRETRAIN_DATASET_CFG),
                               '--work-dir', os.path.join(work_dir, 'full')],
            kernels, expected)
        wait = [line for line in out.splitlines()
                if 'waiting for the loader' in line]
        if len(wait) != 1 or out.count('Epoch [1/1]') != 4:
            raise AssertionError('the pretrain entry logged no epoch')
        print(f'pretrain path: train entry on SyntheticSUNRGBD {seconds:.3f} '
              f's in all; {wait[0].split(" - ", 1)[1]}')
        torch.cuda.empty_cache()

        # the hand-over at the tiny size: a pretrain checkpoint written by
        # the entry warm-starts a DeMF model, whose serving forward runs
        for k in kernels.values():
            k.launches = 0
        train_entry.main([os.path.join(root, PRETRAIN_TINY_CFG),
                          '--work-dir', os.path.join(work_dir, 'tiny')])
        tiny_launches = {n: kernels[n].launches
                         for n in ('msda', 'msda_backward')}
        ckpt = latest_checkpoint(os.path.join(work_dir, 'tiny'))
        cfg = zoo.tiny_demf_model_cfg()
        cfg['img_encoder']['encoder']['num_layers'] = 1
        demf = zoo.build_detector(cfg, dev, seed=9)
        missing, unexpected = load_weights(ckpt, demf)
        if unexpected or not missing or not all(
                k.startswith(('pts_backbone.', 'pts_bbox_head.'))
                for k in missing):
            raise AssertionError(f'hand-over: unexpected {unexpected}, '
                                 f'missing {missing[:5]}')
        stage1 = torch.load(ckpt, map_location=dev,
                            weights_only=True)['state_dict']
        carried = 0
        for key, v in demf.state_dict().items():
            if key.startswith(('img_backbone.', 'img_neck.')):
                source = key
            elif key.startswith('img_encoder.'):
                source = key.replace('img_encoder',
                                     'img_bbox_head.transformer', 1)
            else:
                continue
            if not torch.equal(v, stage1[source]):
                raise AssertionError(f'hand-over: {key} differs')
            carried += 1
        det = make_eval_step(demf)(batch_to_device(zoo.synth_demf_batch(
            2, p=1024, g=8, hw=(64, 96), valid_hw=(60, 88), seed=0), dev))
        if not torch.isfinite(det['boxes_3d']).all():
            raise AssertionError('hand-over: non-finite detections')
        print(f'pretrain path: hand-over at the tiny size: the entry\'s '
              f'checkpoint (K3 / K4 launches {tiny_launches}) warm-started '
              f'DeMF: {carried} image-branch tensors equal, {len(missing)} '
              f'point-branch keys left to train, none unexpected; serving '
              f'forward {tuple(det["boxes_3d"].shape)} finite')
        if not all(tiny_launches.values()):
            raise AssertionError('the tiny pretrain launched no K3 / K4')
    return launches


def check_nms2d(dev):
    """K10 against the plain version, keep masks equal bit for bit, at the
    RPN's and the R-CNN's shapes at batch 16 and 2 and at its limit of
    16,384 candidates an image.  Its bound counts the IoUs the sweep can
    ask for on these inputs (the pairs of valid boxes of one group, ~20
    operations a pair) and the bytes (boxes, scores, groups, valid in, the
    mask out); beside it stand the device time of its two kernels (the
    order, then the bits and the sweeps), the count of all kernels a call
    runs on the device (the wrapper's own launches besides them), and the
    least a serial sweep of the longest group could take at the card's
    highest clock."""
    from demf_tpu_torch.ops import nms2d
    from demf_tpu_torch.tools import bound_ms, time_ms
    from demf_tpu_torch.tools.nms_cases import nms2d_case
    rows = []
    clock_hz = max_sm_clock_hz()
    for b, layout, n, thr in NMS2D_SHAPES:
        boxes, scores, idxs, valid = (torch.from_numpy(a).to(dev) for a in
                                      nms2d_case(b, n, groups=5, seed=b,
                                                 layout=layout))
        got = nms2d.batched_nms_2d_cuda(boxes, scores, idxs, thr, valid)
        want = nms2d.batched_nms_2d_plain(boxes, scores, idxs, thr, valid)
        differ = int((got != want).sum())
        ms = time_ms(lambda: nms2d.batched_nms_2d_cuda(
            boxes, scores, idxs, thr, valid), 20)
        kernel_ms, _, on_device = device_ms(
            lambda: nms2d.batched_nms_2d_cuda(boxes, scores, idxs, thr,
                                              valid), 'nms2d_', runs=5)
        plain_ms = time_ms(lambda: nms2d.batched_nms_2d_plain(
            boxes, scores, idxs, thr, valid), 1)
        sizes = torch.stack([((idxs == g) & valid).sum(1)
                             for g in idxs.unique()])
        pairs = int((sizes * (sizes - 1) // 2).sum())
        least, by = bound_ms(20 * pairs, b * n * (16 + 4 + 8 + 1 + 1))
        sweep_ms = int(sizes.max()) * SWEEP_CLOCKS_A_BOX / clock_hz * 1e3
        print(f'K10 nms2d ({b}, N {n}, {layout}, thr {thr}): kept '
              f'{int(got.sum())} of {int(valid.sum())} valid, {differ} mask '
              f'bits differ from plain, through the wrapper {ms:.4f} ms '
              f'(its two kernels {kernel_ms:.4f} ms on the device; '
              f'{on_device} kernels a call in all), plain '
              f'{plain_ms:.4f} ms, bound {least:.6f} ms ({by}; {pairs} '
              f'pairs of one group), a serial sweep of the longest group '
              f'({int(sizes.max())}) at {clock_hz / 1e6:.0f} MHz at least '
              f'{sweep_ms:.6f} ms; library call: none', flush=True)
        if differ:
            raise AssertionError('2D NMS kernel keep masks differ from plain')
        rows.append(kernel_row(differ, ms, plain_ms, least, by))
    return rows[2]


def check_roi_align(dev):
    """K11 against the plain version at the path's shape, batch 16 and 2:
    1,000 RoIs a scene into (7, 7, 256) from the four levels of a 608x832
    image; equal bit for bit (the same roundings), held within 1e-5 of the
    largest output.  Its bound: the bytes (the levels read once, the RoIs
    and levels, the output written once) against ~50 operations an output
    number."""
    from demf_tpu_torch.ops import roi_align
    from demf_tpu_torch.tools import bound_ms, time_ms
    from demf_tpu_torch.tools.roi_cases import roi_case
    rows = []
    for b in (16, 2):
        feats, rois, lvl = roi_case(dev, b, seed=b)
        strides = (4, 8, 16, 32)
        got = roi_align.pyramid_roi_align_cuda(feats, rois, lvl, strides)
        want = roi_align.pyramid_roi_align_plain(feats, rois, lvl, strides)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ms = time_ms(lambda: roi_align.pyramid_roi_align_cuda(
            feats, rois, lvl, strides), 20)
        plain_ms = time_ms(lambda: roi_align.pyramid_roi_align_plain(
            feats, rois, lvl, strides), 1)
        # each level read once, the RoIs and their levels, the output
        least, by = bound_ms(50 * got.numel(), 4 * (
            sum(f.numel() for f in feats) + rois.numel() + lvl.numel() +
            got.numel()))
        per_level = [int((lvl == i).sum()) for i in range(4)]
        print(f'K11 roi_align (B {b}, 1000 RoIs a scene, levels '
              f'{per_level}, out {tuple(got.shape)}): max |kernel - plain| '
              f'{err:.3e} (bound 1e-5 x {scale:.3f}; equal bit for bit: '
              f'{torch.equal(got, want)}), kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, bound {least:.6f} ms ({by}), '
              f'{least / ms:.1%} of it; library call: none', flush=True)
        if not err <= 1e-5 * scale:
            raise AssertionError('RoIAlign kernel disagrees with plain')
        rows.append(kernel_row(err, ms, plain_ms, least, by))
    return rows[1]


class imvotenet_probe:
    """Keep what an ImVoteNet forward decided, as tensors read after it:
    the proposals' valid masks, the 2D boxes' valid masks and the masks of
    the seeds' image votes."""

    def __init__(self, model):
        self.model = model
        self.proposals, self.boxes, self.votes = [], [], []

    def __enter__(self):
        from demf_tpu_torch.models import imvotenet
        rpn = self.model.img_rpn_head
        self.saved = (rpn.get_proposals, self.model.extract_bboxes_2d,
                      imvotenet.sample_valid_seeds)
        get_proposals, extract, sample = self.saved

        def proposals(*args):
            out = get_proposals(*args)
            self.proposals.append(out[2])
            return out

        def boxes(*args):
            out = extract(*args)
            self.boxes.append(out[1])
            return out

        def seeds(mask, *args):
            self.votes.append(mask.reshape(mask.shape[0], 3, -1).any(1))
            return sample(mask, *args)

        rpn.get_proposals = proposals
        self.model.extract_bboxes_2d = boxes
        imvotenet.sample_valid_seeds = seeds
        return self

    def __exit__(self, *exc):
        from demf_tpu_torch.models import imvotenet
        del self.model.img_rpn_head.get_proposals
        del self.model.extract_bboxes_2d
        imvotenet.sample_valid_seeds = self.saved[2]

    def counts(self):
        """'proposals / 2D boxes / seeds with image votes' of each scene of
        the last forward."""
        return ', '.join(
            f'{int(p)} / {int(bx)} / {int(v)}' for p, bx, v in zip(
                self.proposals[-1].sum(1), self.boxes[-1].sum(1),
                self.votes[-1].sum(1)))


def in_view(batch):
    """The synthetic scene's points moved into the camera's view (a numpy
    batch of ``zoo.synth_demf_batch``): its cube of 6 m around the camera
    puts half the points behind it and most of the rest outside the image,
    where a real depth frame has every point in front.  Depth 1-4 m, the
    other two axes within the field of view; the GT boxes stay."""
    pts = batch['points']
    depth = 1.0 + np.abs(pts[..., 1])
    pts[..., 0] = pts[..., 0] / 3 * 0.7 * depth
    pts[..., 2] = pts[..., 2] / 3 * 0.5 * depth
    pts[..., 1] = depth
    return batch


def confident_imvotenet(dev, trainer=False, bf16=False):
    """The full-width ImVoteNet with seeded weights, its R-CNN's fc_cls
    scaled by ``RCNN_CONFIDENCE`` and the RPN's and R-CNN's regressors by
    ``REGRESSOR_SCALE``; with ``trainer`` its AdamW and train step too
    (under the bf16 policy with ``bf16``)."""
    from demf_tpu_torch import zoo
    if trainer:
        cfg = zoo.load_model_cfg(IMVOTENET_CFG)
        cfg['bf16'] = bf16
        model, _, step = zoo.build_trainer(cfg, dev, seed=0)
    else:
        model, step = zoo.build_detector(IMVOTENET_CFG, dev, seed=0), None
    with torch.no_grad():
        model.img_roi_head.bbox_head.fc_cls.weight.mul_(RCNN_CONFIDENCE)
        model.img_roi_head.bbox_head.fc_reg.weight.mul_(REGRESSOR_SCALE)
        model.img_rpn_head.rpn_reg.weight.mul_(REGRESSOR_SCALE)
    return model, step


def run_imvotenet_path(dev, kernels):
    """ImVoteNet at full width: the kernel path against the plain path,
    requests of batch 2, the stage-2 step at batch 16 (the 2D branch in the
    step), the train entry's synthetic mode with its profile, and the
    dataset path on ``demf_tpu_torch/configs/imvotenet_synthetic.py``.
    Returns the launches by sub-path."""
    from demf_tpu_torch import eval as eval_entry
    from demf_tpu_torch import train as train_entry
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import (batch_to_device, latest_checkpoint,
                                       make_eval_step)
    from demf_tpu_torch.models import imvotenet
    t0 = time.perf_counter()
    model, _ = confident_imvotenet(dev)
    print(f'imvotenet: configs/baseline/imvotenet.py full width, '
          f'{sum(p.numel() for p in model.parameters())} parameters, built '
          f'in {time.perf_counter() - t0:.2f} s; fc_cls x {RCNN_CONFIDENCE}, '
          f'rpn_reg and fc_reg x {REGRESSOR_SCALE}', flush=True)
    batch = batch_to_device(in_view(zoo.synth_batch_for(model, b=2,
                                                        seed=11)), dev)
    with torch.inference_mode(), imvotenet_probe(model) as probe:
        got = model(batch)
        got_det = model.get_bboxes(got, batch)
        kernel_counts = probe.counts()
        with plain_ops():
            want = model(batch)
            want_det = model.get_bboxes(want, batch)
    worst = 0.0
    for tower in imvotenet.TOWERS:
        for key in ('vote_points', 'aggregated_points', 'obj_scores',
                    'sem_scores', 'distance', 'dir_class', 'dir_res_norm'):
            g, w = got[tower][key], want[tower][key]
            if not torch.isfinite(g).all():
                raise AssertionError(f'non-finite {tower} {key}')
            worst = max(worst, (g - w).abs().max().item() /
                        max(w.abs().max().item(), 1e-3))
    same = all(torch.equal(got_det[k], want_det[k]) for k in got_det) and \
        torch.equal(got['bboxes_2d_valid'], want['bboxes_2d_valid'])
    print(f'imvotenet reference: batch 2 x 20000 points, 608x832: kernel '
          f'path vs plain path, towers max rel err {worst:.3e} (bound '
          f'2e-3), 2D boxes and detections equal: {same}; proposals / 2D '
          f'boxes / seeds with image votes a scene: {kernel_counts}',
          flush=True)
    if not (worst < 2e-3 and same):
        raise AssertionError('imvotenet kernel path disagrees with plain')

    # the joint tower's proposals, one a class
    head = model.pts_bbox_head_joint
    proposals = head.num_proposal * head.num_classes
    eval_step = make_eval_step(model)
    for k in kernels.values():
        k.launches = 0
    for seed in REQUESTS:
        before = {n: k.launches for n, k in kernels.items()}
        torch.cuda.reset_peak_memory_stats()
        batch = batch_to_device(in_view(zoo.synth_demf_batch(
            seed=seed, **IMVOTENET_REQUEST)), dev)
        with imvotenet_probe(model) as probe:
            t0 = time.perf_counter()
            det = eval_step(batch)
            torch.cuda.synchronize()
            latency = (time.perf_counter() - t0) * 1e3
        launched = {n: k.launches - before[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_IMVOTENET_REQUEST:
            raise AssertionError(f'imvotenet request {seed} launched '
                                 f'{launched}')
        if tuple(det['boxes_3d'].shape) != (2, proposals, 7) or not all(
                torch.isfinite(det[k]).all() for k in ('boxes_3d',
                                                       'scores_3d')):
            raise AssertionError('imvotenet detections')
        if not probe.boxes[-1].any() or not probe.votes[-1].any():
            raise AssertionError('no 2D box passed, or no seed has a vote')
        print(f'imvotenet request {seed}: latency {latency:.3f} ms (host '
              f'clock, batch 2, 20000 points, 608x832), proposals / 2D '
              f'boxes / seeds with image votes a scene {probe.counts()}, '
              f'{int(det["valid"].sum())} valid detections, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB',
              flush=True)
    by_path = {'imvotenet_serving': {n: k.launches
                                     for n, k in kernels.items()}}
    profile_request(eval_step, batch)
    del eval_step, model, batch
    torch.cuda.empty_cache()

    model, step = confident_imvotenet(dev, trainer=True)
    batch = batch_to_device(in_view(zoo.synth_batch_for(model, seed=0)),
                            dev)
    b, p = batch['points'].shape[:2]
    if tuple(batch['img'].shape[:3]) != IMVOTENET_STEP_BATCH or \
            batch['gt_valid'].shape[1] != 64:
        raise AssertionError('imvotenet step batch of another shape')
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    with imvotenet_probe(model) as probe:
        for i in range(IMVOTENET_STEPS):
            start = {n: k.launches for n, k in kernels.items()}
            t0 = time.perf_counter()
            metrics = step(batch, generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launched = {n: k.launches - start[n] for n, k in kernels.items()}
            if launched != LAUNCHES_PER_IMVOTENET_STEP:
                raise AssertionError(f'imvotenet step {i} launched '
                                     f'{launched}')
            if not all(torch.isfinite(v) for v in metrics.values()):
                raise AssertionError(f'imvotenet step {i}: non-finite')
            if i == 0:
                first = {k: v.item() for k, v in metrics.items()}
    by_path['imvotenet_step'] = {n: k.launches for n, k in kernels.items()}
    frozen = moved = 0
    for name, param in model.named_parameters():
        unchanged = torch.equal(param.detach(), before[name])
        if name.startswith(model.img_branch):
            if not unchanged:
                raise AssertionError(f'frozen {name} changed')
            frozen += 1
        else:
            moved += not unchanged
    print(f'imvotenet step: batch {b} x {p} points, images '
          f'{tuple(batch["img"].shape[1:3])}, 64 GT, the 2D branch in the '
          f'step: ' +
          ', '.join(f'{t * 1e3:.3f}' for t in times) + ' ms (host clock), '
          f'after the first {b / np.mean(times[1:]):.3f} scenes/s; peak '
          f'memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; '
          f'loss {metrics["loss"].item():.5f}; {frozen} 2D-branch tensors '
          f'unchanged, {moved} trained tensors moved; 2D boxes after the '
          f'half-drop a scene '
          f'{probe.boxes[-1].sum(1).tolist()}', flush=True)
    if not moved or not probe.votes[-1].any():
        raise AssertionError('imvotenet step: nothing moved or no votes')
    del model, step, batch
    torch.cuda.empty_cache()

    # the entry's synthetic mode: 2 steps, then one untraced and one traced
    # (its R-CNN as built: at random weights few 2D boxes pass score_thr)
    _, out, seconds, _ = run_entry(
        train_entry.main, [IMVOTENET_CFG, '--synthetic', '--steps', '2',
                           '--profile'], kernels,
        {n: 4 * c for n, c in LAUNCHES_PER_IMVOTENET_STEP.items()})
    if out.count('Epoch [1/1]') != 2 or 'profiled step' not in out:
        raise AssertionError('the imvotenet entry logged no steps')
    print(f'imvotenet: train entry --synthetic --steps 2 --profile '
          f'{seconds:.3f} s in all', flush=True)
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(root, IMVOTENET_DATASET_CFG)
    build_dir = os.path.join(root, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        np.random.seed(0)
        _, out, seconds, launches = run_entry(
            train_entry.main, [cfg_file, '--work-dir', work_dir], kernels,
            LAUNCHES_IMVOTENET_TRAIN_ENTRY)
        wait = [line for line in out.splitlines()
                if 'waiting for the loader' in line]
        if len(wait) != 1 or out.count('[eval @ epoch 1]') != 1 or \
                'image-feature cache' in out:
            raise AssertionError('the imvotenet train entry logged no epoch '
                                 'or eval, or filled a feature cache')
        print(f'imvotenet dataset path: train entry {seconds:.3f} s in all; '
              f'{wait[0].split(" - ", 1)[1]}; launches {launches}',
              flush=True)
        ckpt = latest_checkpoint(work_dir)
        out_file = os.path.join(work_dir, 'results.pkl')
        torch.cuda.reset_peak_memory_stats()
        np.random.seed(7)
        metrics, out, seconds, eval_launches = run_entry(
            eval_entry.main, [cfg_file, ckpt, '--eval', 'mAP', '--out',
                              out_file], kernels,
            LAUNCHES_IMVOTENET_EVAL_ENTRY)
        with open(out_file, 'rb') as f:
            results = pickle.load(f)
        if len(results) != VAL_SCENES or not all(
                np.isfinite(r['boxes_3d']).all() for r in results) or \
                not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError('imvotenet eval entry: results or mAP')
        print(f'imvotenet dataset path: eval entry {seconds:.3f} s in all, '
              f'{len(results) / seconds:.3f} scenes/s, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, '
              f'{sum(len(r["scores_3d"]) for r in results)} detections, '
              f'mAP_0.25 {metrics["mAP_0.25"]:.4f} mAP_0.50 '
              f'{metrics["mAP_0.50"]:.4f} (random weights), launches '
              f'{eval_launches}', flush=True)
    by_path['imvotenet_dataset'] = {n: launches[n] + eval_launches[n]
                                    for n in launches}
    by_path.update(run_imvotenet_bf16(dev, kernels, first))
    by_path['deformdetr_fusion_bf16'] = run_deformdetr_fusion_bf16(
        dev, kernels)
    return by_path


def check_roi_align_backward(dev):
    """K12 against the plain version's autograd at the step's shape, batch
    16 and 2: 512 sampled RoIs a scene, (7, 7, 256) bins, the four levels
    of a 608x832 image; within 1e-5 of the largest gradient, the same bits
    in two calls, and at batch 2 equal bit for bit to the plain version of
    its order (``pyramid_roi_align_backward_tiles_plain``).  Spread RoIs
    (the ``kernels`` line's row, batch 16), then at batch 16 RoIs crowded
    as the R-CNN's sampler hands them over and RoIs piled onto one box,
    each on its own line.  Its time through the wrapper (nothing filled:
    every pixel is written once), its kernels' device time, the plain
    version's; its bound: d_out read once and the levels' gradient written
    once, against ~50 operations a d_out number (16 weighted corners)."""
    from demf_tpu_torch.ops import roi_align
    from demf_tpu_torch.tools import bound_ms, device_kernels, time_ms
    from demf_tpu_torch.tools.roi_cases import ROI_STRIDES, k12_case
    rows = []
    spread_ms = {}
    for b, kind in ((16, 'spread'), (2, 'spread'), (16, 'crowded'),
                    (16, 'piled')):
        d_out, shapes, rois, lvl = k12_case(dev, b, kind, FRCNN_ROIS,
                                            seed=b)

        def kernel():
            return roi_align.pyramid_roi_align_backward_cuda(
                d_out, shapes, rois, lvl, ROI_STRIDES)

        got, again = kernel(), kernel()
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        del again
        want = roi_align.pyramid_roi_align_backward_plain(
            d_out, shapes, rois, lvl, ROI_STRIDES)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        del want
        ordered = 'not held at batch 16'
        if b == 2:
            ordered = all(torch.equal(g, w) for g, w in zip(
                got, roi_align.pyramid_roi_align_backward_tiles_plain(
                    d_out, shapes, rois, lvl, ROI_STRIDES)))
        del got
        torch.cuda.empty_cache()
        ms = time_ms(kernel, 20)
        by_kernel = {k: v for k, v in device_kernels(kernel).items()
                     if 'roi_align_backward' in k}
        plain_ms = time_ms(lambda: roi_align.pyramid_roi_align_backward_plain(
            d_out, shapes, rois, lvl, ROI_STRIDES), 1)
        grad_bytes = 4 * sum(int(np.prod(sh)) for sh in shapes)
        least, by = bound_ms(50 * d_out.numel(),
                             4 * d_out.numel() + grad_bytes)
        if kind == 'spread':
            spread_ms[b] = ms
        per_level = lvl.flatten().bincount(minlength=len(shapes)).tolist()
        print(f'K12 roi_align_backward, {kind} RoIs (B {b}, {FRCNN_ROIS} '
              f'RoIs a scene, {per_level} on the levels, d_out '
              f'{tuple(d_out.shape)}): max |kernel - plain| '
              f'{err:.3e} (bound 1e-5 x {scale:.3f}), the same bits in two '
              f'calls: {same}, equal to the plain version of its order: '
              f'{ordered}; through the wrapper {ms:.4f} ms '
              f'({ms / spread_ms[b]:.2f}x spread; on the device, ms a '
              f'launch (launches recorded a call): ' + ', '.join(
                  f'{k[len("roi_align_backward_"):]} {t / n:.4f} ({n:g})'
                  for k, (n, t) in by_kernel.items()) +
              f'; nothing filled), plain {plain_ms:.4f} ms, bound '
              f'{least:.6f} ms ({by}: d_out {4 * d_out.numel() / 1e6:.1f} '
              f'MB read, the levels\' gradient {grad_bytes / 1e6:.1f} MB '
              f'written), {least / ms:.1%} of it; library call: none',
              flush=True)
        if not (err <= 1e-5 * scale and same and ordered):
            raise AssertionError(f'RoIAlign backward kernel ({kind}, B {b}) '
                                 f'disagrees with plain or with itself')
        rows.append(kernel_row(err, ms, plain_ms, least, by))
        del d_out
        torch.cuda.empty_cache()
    return rows[0]


def check_nms2d_training_shape(dev):
    """K10 at the RPN's training shape (16 images, 7,872 candidates in 5
    level groups: nms_pre 2000 of a 608x832 image's levels), keep masks
    equal to the plain version's bit for bit; its bound as
    ``check_nms2d`` counts it."""
    from demf_tpu_torch.ops import nms2d
    from demf_tpu_torch.tools import bound_ms, time_ms
    from demf_tpu_torch.tools.nms_cases import RPN_TRAIN_LEVELS, nms2d_case
    n = sum(RPN_TRAIN_LEVELS)
    boxes, scores, idxs, valid = (torch.from_numpy(a).to(dev) for a in
                                  nms2d_case(16, n, seed=17,
                                             layout='rpn_train'))

    def kernel():
        return nms2d.batched_nms_2d_cuda(boxes, scores, idxs, 0.7, valid)

    got = kernel()
    want = nms2d.batched_nms_2d_plain(boxes, scores, idxs, 0.7, valid)
    differ = int((got != want).sum())
    ms = time_ms(kernel, 20)
    kernel_ms, _, on_device = device_ms(kernel, 'nms2d_')
    plain_ms = time_ms(lambda: nms2d.batched_nms_2d_plain(
        boxes, scores, idxs, 0.7, valid), 1)
    sizes = torch.stack([((idxs == g) & valid).sum(1)
                         for g in idxs.unique()])
    pairs = int((sizes * (sizes - 1) // 2).sum())
    least, by = bound_ms(20 * pairs, 16 * n * (16 + 4 + 8 + 1 + 1))
    print(f'K10 nms2d at the RPN\'s training shape (16, N {n}, 5 level '
          f'groups): kept {int(got.sum())}, {differ} mask bits differ from '
          f'plain, through the wrapper {ms:.4f} ms (its two kernels '
          f'{kernel_ms:.4f} ms on the device; {on_device} kernels a call), '
          f'plain {plain_ms:.4f} ms, bound {least:.6f} ms ({by}; {pairs} '
          f'pairs of one group); library call: none', flush=True)
    if differ:
        raise AssertionError('2D NMS kernel keep masks differ from plain')


def frcnn_cfg():
    from demf_tpu_torch.utils.config import Config
    return Config.fromfile(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), FRCNN_CFG))


def check_frcnn_reference(dev):
    """The full-width image-only Faster R-CNN, batch 2 of 608x832 with 64
    GT slots: one forward + loss + backward on the kernel path against the
    plain path, two copies of the same weights on the same draws (a
    generator of the same seed): losses within 1e-4 relative, the FPN's,
    RPN's and RoI head's gradients within 1e-3 of each tensor's largest."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    model = zoo.build_detector(frcnn_cfg().model, dev, seed=0).train()
    plain_model = copy.deepcopy(model)
    batch = batch_to_device(zoo.synth_batch_for(model, b=2, seed=5), dev)
    branches = ('img_neck', 'img_rpn_head', 'img_roi_head')

    def loss_and_grads(m):
        results = m(batch, generator=torch.Generator(dev).manual_seed(0))
        losses = m.loss(results, batch)
        sum(losses.values()).backward()
        return ({k: v.detach() for k, v in losses.items()},
                {n: p.grad for n, p in m.named_parameters()
                 if n.startswith(branches)})

    got_l, got_g = loss_and_grads(model)
    with plain_ops():
        want_l, want_g = loss_and_grads(plain_model)
    loss_err = max(abs(got_l[k].item() - w.item()) / max(abs(w.item()), 1e-6)
                   for k, w in want_l.items())
    largest = max(w.abs().max().item() for w in want_g.values())
    grad_err = 0.0
    for name, w in want_g.items():
        scale = w.abs().max().item()
        if scale < 1e-6 * largest:
            if got_g[name].abs().max().item() >= 1e-6 * largest:
                raise AssertionError(f'{name}: gradient above noise')
            continue
        grad_err = max(grad_err, (got_g[name] - w).abs().max().item() /
                       scale)
    terms = ', '.join(f'{k} {v.item():.5f}' for k, v in want_l.items())
    print(f'frcnn reference: full width, batch 2 x 608x832, 64 GT slots: '
          f'kernel path vs plain path, losses max rel err {loss_err:.3e} '
          f'(bound 1e-4), FPN / RPN / RoI head gradients max err / tensor '
          f'max {grad_err:.3e} (bound 1e-3) over {len(want_g)} tensors; '
          f'plain losses: {terms}', flush=True)
    if not (loss_err < 1e-4 and grad_err < 1e-3 and
            all(torch.isfinite(v) for v in got_l.values())):
        raise AssertionError('frcnn kernel path disagrees with plain')


def time_anchor_assigner(batch):
    """The RPN's anchor assigner in plain torch (ROADMAP B6): ``iou_2d``
    and ``max_iou_assign`` over a 608x832 image's 126,360 anchors and the
    batch's GT slots, timed on the card."""
    from demf_tpu_torch.models import rpn_roi
    from demf_tpu_torch.models.assign_sample import iou_2d, max_iou_assign
    from demf_tpu_torch.tools import time_ms
    gt, valid = batch['gt_bboxes'], batch['gt_bboxes_valid']
    anchors = torch.cat([rpn_roi.grid_anchors(
        (-(-FRCNN_STEP_BATCH[1] // s), -(-FRCNN_STEP_BATCH[2] // s)), s, [8],
        [0.5, 1.0, 2.0], gt.device) for s in (4, 8, 16, 32, 64)])
    ms = time_ms(lambda: max_iou_assign(iou_2d(anchors, gt), valid, 0.7, 0.3,
                                        0.3, True), 5)
    print(f'anchor assigner (iou_2d + max_iou_assign, plain torch): '
          f'{gt.shape[0]} images x {anchors.shape[0]} anchors x '
          f'{gt.shape[1]} GT slots, {ms:.4f} ms on the card', flush=True)
    if anchors.shape[0] != 126360:
        raise AssertionError(f'{anchors.shape[0]} anchors')


def frcnn_step_kernels(label, step, batch, generator):
    """K12's, K11's and K10's device ms in an image-only step, and all the
    step's kernels' (``kernels_a_call`` over 2 steps)."""
    found = kernels_a_call(lambda: step(batch, generator), dict(
        k12=('roi_align_backward',), k11=('roi_align_kernel',),
        k10=('nms2d_',)), runs=2)
    print(f'{label} step on the device (tools.device_kernels, 2 profiled '
          f'steps): all kernels {found["all"][0]:.3f} ms a step, of them ' +
          ', '.join(f'{k.upper()} {found[k][0]:.3f} ms in {found[k][1]} '
                    f'kernels' for k in ('k12', 'k11', 'k10')), flush=True)
    return found


def run_frcnn_path(dev, kernels):
    """The image-only Faster R-CNN at full width: K12 and K10 at the
    step's shapes, the kernel path against the plain path, 3 steps at
    batch 16, a request of batch 2, the train entry's synthetic mode with
    its profile and its dataset mode, and the checkpoint it writes warm-
    starting the stage-2 ImVoteNet.  Returns (K12's row, the launches by
    sub-path)."""
    from demf_tpu_torch import train as train_entry
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import (batch_to_device, latest_checkpoint,
                                       load_weights)
    row = check_roi_align_backward(dev)
    check_nms2d_training_shape(dev)
    torch.cuda.empty_cache()
    check_frcnn_reference(dev)
    torch.cuda.empty_cache()

    cfg = frcnn_cfg()
    cfg.optimizer['lr'] = FRCNN_SMOKE_LR
    model, _, step = zoo.build_trainer(cfg, dev, seed=0)
    batch = batch_to_device(zoo.synth_batch_for(model, seed=0), dev)
    if tuple(batch['img'].shape[:3]) != FRCNN_STEP_BATCH or \
            batch['gt_bboxes'].shape[1] != 64:
        raise AssertionError('frcnn step batch of another shape')
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    for i in range(FRCNN_STEPS):
        start = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_FRCNN_STEP:
            raise AssertionError(f'frcnn step {i} launched {launched}')
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'frcnn step {i}: non-finite')
        if i == 0:
            first = {k: v.item() for k, v in metrics.items()}
    by_path = {'frcnn_step': {n: k.launches for n, k in kernels.items()}}
    terms = ', '.join(f'{k} {v.item():.4f}' for k, v in metrics.items())
    print(f'frcnn step: batch {FRCNN_STEP_BATCH[0]} x '
          f'{FRCNN_STEP_BATCH[1]}x{FRCNN_STEP_BATCH[2]}, 64 GT slots, '
          f'{FRCNN_ROIS} RoIs an image: ' +
          ', '.join(f'{t * 1e3:.3f}' for t in times) + ' ms (host clock), '
          f'after the first {FRCNN_STEP_BATCH[0] / np.mean(times[1:]):.3f} '
          f'images/s; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; '
          f'launches a step {launched}; last step: {terms}', flush=True)
    train_entry.profile_step(step, batch, generator, dev)
    frcnn_step_kernels('frcnn', step, batch, generator)
    time_anchor_assigner(batch)
    del model, step
    torch.cuda.empty_cache()

    model = zoo.build_detector(frcnn_cfg().model, dev, seed=1)
    batch = batch_to_device(zoo.synth_batch_for(model, b=2, seed=3), dev)
    with torch.inference_mode():
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = model.get_bboxes(model(batch), batch)
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        launched = {n: k.launches for n, k in kernels.items()}
        with plain_ops():
            want = model.get_bboxes(model(batch), batch)
    by_path['frcnn_request'] = launched
    same = all(torch.equal(det[k], want[k]) for k in det)
    print(f'frcnn request: batch 2 x 608x832, {latency:.3f} ms (host clock, '
          f'the first at this shape), {int(det["valid"].sum())} valid 2D '
          f'detections of {det["valid"].numel()}, equal to the plain '
          f'path\'s: {same}; launches {launched}', flush=True)
    if launched != LAUNCHES_PER_FRCNN_REQUEST or not same or \
            not det['valid'].any():
        raise AssertionError('frcnn request')
    del model, batch, det, want
    torch.cuda.empty_cache()

    cfg_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            FRCNN_CFG)
    lr = ['--cfg-options', f'optimizer.lr={FRCNN_SMOKE_LR}']
    _, out, seconds, launches = run_entry(
        train_entry.main, [cfg_file, '--synthetic', '--steps', '3',
                           '--profile', *lr], kernels,
        {n: 5 * c for n, c in LAUNCHES_PER_FRCNN_STEP.items()})
    if out.count('Epoch [1/1]') != 3 or 'profiled step' not in out:
        raise AssertionError('the frcnn entry logged no steps')
    by_path['frcnn_entry_synthetic'] = launches
    print(f'frcnn: train entry --synthetic --steps 3 --profile '
          f'{seconds:.3f} s in all', flush=True)
    torch.cuda.empty_cache()

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        np.random.seed(0)
        _, out, seconds, launches = run_entry(
            train_entry.main, [cfg_file, '--work-dir', work_dir, *lr],
            kernels, {n: FRCNN_DATASET_STEPS * c
             for n, c in LAUNCHES_PER_FRCNN_STEP.items()})
        wait = [line for line in out.splitlines()
                if 'waiting for the loader' in line]
        if len(wait) != 1 or out.count('Epoch [1/1]') != \
                FRCNN_DATASET_STEPS:
            raise AssertionError('the frcnn train entry logged no epoch')
        by_path['frcnn_dataset'] = launches
        stage2 = zoo.build_detector(IMVOTENET_CFG, dev, seed=0)
        missing, unexpected = load_weights(latest_checkpoint(work_dir),
                                           stage2)
        branch = [k for k in missing if k.startswith(stage2.img_branch)]
        print(f'frcnn dataset path: train entry {seconds:.3f} s in all; '
              f'{wait[0].split(" - ", 1)[1]}; launches {launches}; its '
              f'checkpoint warm-starts configs/baseline/imvotenet.py with '
              f'{len(branch)} keys of the 2D branch missing ({len(missing)} '
              f'missing in all: the point branch, towers and image MLP), '
              f'{len(unexpected)} unexpected', flush=True)
        if branch or unexpected:
            raise AssertionError('the frcnn checkpoint does not warm-start '
                                 'the stage-2 2D branch')
        del stage2
    torch.cuda.empty_cache()
    by_path.update(run_frcnn_bf16(dev, kernels, first))
    return row, by_path


def run_mmcv_checkpoint(dev, kernels):
    """A released mmcv-format file (its epoch and CLASSES in ``meta``, no
    top-level epoch) of the full-width DeMF-VoteNet's seeded weights, read
    by ``demf_tpu_torch.eval`` on the dataset path's config: the classes
    taken from the file, the epoch read as the port's count, 18 finite
    results.  Returns the eval entry's launches."""
    from demf_tpu_torch import eval as eval_entry
    from demf_tpu_torch import zoo
    from demf_tpu_torch.utils.config import Config
    root = os.path.dirname(os.path.abspath(__file__))
    cfg_file = os.path.join(root, DATASET_CFG)
    cfg = Config.fromfile(cfg_file)
    model = with_size_prior(zoo.build_detector(cfg.model, dev, seed=0))
    classes = tuple(reversed(cfg.class_names))
    build_dir = os.path.join(root, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        path = os.path.join(work_dir, 'released.pth')
        torch.save(dict(state_dict=model.state_dict(), meta=dict(
            epoch=36, iter=36 * 1200, CLASSES=classes, mmcv_version='1.4.0',
            config=cfg.dump())), path)
        del model
        out_file = os.path.join(work_dir, 'results.pkl')
        np.random.seed(7)
        metrics, out, seconds, launches = run_entry(
            eval_entry.main, [cfg_file, path, '--eval', 'mAP', '--out',
                              out_file], kernels, LAUNCHES_EVAL_ENTRY)
        with open(out_file, 'rb') as f:
            results = pickle.load(f)
    taken = f'using CLASSES from checkpoint meta: {classes}' in out
    epoch_read = "'epoch': 35" in out
    print(f'mmcv-format checkpoint: eval entry {seconds:.3f} s in all, '
          f'{len(results)} results, CLASSES taken from its meta: {taken}, '
          f'its epoch read as 35: {epoch_read}, mAP_0.25 '
          f'{metrics["mAP_0.25"]:.4f} (random weights)', flush=True)
    if not (taken and epoch_read) or len(results) != VAL_SCENES or not all(
            np.isfinite(r['boxes_3d']).all() for r in results):
        raise AssertionError('the mmcv-format checkpoint through eval')
    return launches


def check_roi_align_bf16(dev):
    """K11 and K12 on bf16 levels (their bf16 entries), the FPN's dtype
    under the bf16 policy.  K11 at (2 and 16) x 1,000 RoIs a scene, spread,
    and at 16 x 512 on spread, crowded and piled RoIs: float32 out, equal
    bit for bit to K11 on the levels widened and to the plain version.
    K12 at (16 and 2) x 512, spread, and at 16 on crowded and piled RoIs:
    bf16 gradients, the same bits in two calls, equal bit for bit to the
    float32 K12 rounded once (which equals the plain version of its order)
    and at batch 2 to ``pyramid_roi_align_backward_tiles_plain`` rounded.
    Each beside its bound with the levels at 2 bytes a number; K12's
    kernels' device ms by ``tools.device_kernels``.  -> (K11 bf16's row at
    (2, 1,000), K12 bf16's at (16, 512) spread)."""
    from demf_tpu_torch.ops import roi_align
    from demf_tpu_torch.tools import bound_ms, device_kernels, time_ms
    from demf_tpu_torch.tools.roi_cases import (ROI_STRIDES, k12_case,
                                                roi_case)
    bf16 = torch.bfloat16
    rows = {}
    cases = [(2, 'spread', 1000), (16, 'spread', 1000)] + [
        (16, kind, FRCNN_ROIS) for kind in ('spread', 'crowded', 'piled')]
    for b, kind, r in cases:
        if r == 1000:
            feats, rois, lvl = roi_case(dev, b, seed=b)
        else:
            _, shapes, rois, lvl = k12_case(dev, b, kind, r, seed=b)
            gen = torch.Generator(dev).manual_seed(b)
            feats = tuple(torch.randn(sh, device=dev, generator=gen)
                          for sh in shapes)
        feats = tuple(f.to(bf16) for f in feats)
        widened = tuple(f.float() for f in feats)
        got = roi_align.pyramid_roi_align_cuda(feats, rois, lvl, ROI_STRIDES)
        same = torch.equal(got, roi_align.pyramid_roi_align_cuda(
            widened, rois, lvl, ROI_STRIDES))
        want = roi_align.pyramid_roi_align_plain(feats, rois, lvl,
                                                 ROI_STRIDES)
        err = (got - want).abs().max().item()
        plain_same = torch.equal(got, want)
        del widened, want
        ms = time_ms(lambda: roi_align.pyramid_roi_align_cuda(
            feats, rois, lvl, ROI_STRIDES), 20)
        plain_ms = time_ms(lambda: roi_align.pyramid_roi_align_plain(
            feats, rois, lvl, ROI_STRIDES), 1)
        least, by = bound_ms(50 * got.numel(), 2 * sum(
            f.numel() for f in feats) + 4 * (rois.numel() + lvl.numel() +
                                              got.numel()))
        print(f'K11 roi_align_bf16 (B {b}, {r} RoIs a scene, {kind}, bf16 '
              f'levels, out {tuple(got.shape)} {got.dtype}): equal bit for '
              f'bit to K11 on the levels widened: {same}, to the plain '
              f'version: {plain_same} (max |kernel - plain| {err:.3e}); '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{least:.6f} ms ({by}, the levels at 2 bytes), {least / ms:.1%}'
              f' of it; library call: none', flush=True)
        if not (same and plain_same):
            raise AssertionError('K11 on bf16 levels disagrees')
        if (b, r, kind) == (2, 1000, 'spread'):
            rows['roi_align_bf16'] = kernel_row(err, ms, plain_ms, least, by)
        del feats, got
        torch.cuda.empty_cache()

    for b, kind in ((16, 'spread'), (2, 'spread'), (16, 'crowded'),
                    (16, 'piled')):
        d_out, shapes, rois, lvl = k12_case(dev, b, kind, FRCNN_ROIS,
                                            seed=b)

        def kernel():
            return roi_align.pyramid_roi_align_backward_cuda(
                d_out, shapes, rois, lvl, ROI_STRIDES, dtype=bf16)

        got, again = kernel(), kernel()
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        del again
        f32 = roi_align.pyramid_roi_align_backward_cuda(
            d_out, shapes, rois, lvl, ROI_STRIDES)
        rounded = all(torch.equal(g, w.to(bf16)) for g, w in zip(got, f32))
        # against its plain version (the float32 sums rounded once), and
        # the rounding itself against the float32 gradient
        err = max((g - w.to(bf16)).abs().max().item()
                  for g, w in zip(got, f32))
        rounding = max((g.float() - w).abs().max().item()
                       for g, w in zip(got, f32))
        del f32
        ordered = 'held through the float32 kernel at batch 16'
        if b == 2:
            ordered = all(torch.equal(g, w.to(bf16)) for g, w in zip(
                got, roi_align.pyramid_roi_align_backward_tiles_plain(
                    d_out, shapes, rois, lvl, ROI_STRIDES)))
        dtypes = {str(g.dtype) for g in got}
        del got
        torch.cuda.empty_cache()
        ms = time_ms(kernel, 20)
        by_kernel = {k: v for k, v in device_kernels(kernel).items()
                     if 'roi_align_backward' in k}
        plain_ms = time_ms(lambda: roi_align.pyramid_roi_align_backward_plain(
            d_out, shapes, rois, lvl, ROI_STRIDES), 1)
        grad_bytes = 2 * sum(int(np.prod(sh)) for sh in shapes)
        least, by = bound_ms(50 * d_out.numel(),
                             4 * d_out.numel() + grad_bytes)
        print(f'K12 roi_align_backward_bf16, {kind} RoIs (B {b}, '
              f'{FRCNN_ROIS} RoIs a scene): gradients {dtypes}, the same '
              f'bits in two calls: {same}, equal bit for bit to the float32 '
              f'kernel rounded once: {rounded} (max |bf16 - float32| '
              f'{rounding:.3e}), to the plain version of its order rounded: '
              f'{ordered}; through the wrapper {ms:.4f} ms (on the device, '
              f'ms a launch (launches recorded a call): ' + ', '.join(
                  f'{k[len("roi_align_backward_"):]} {t / n:.4f} ({n:g})'
                  for k, (n, t) in by_kernel.items()) +
              f'), plain (float32 autograd) {plain_ms:.4f} ms, bound '
              f'{least:.6f} ms ({by}: d_out {4 * d_out.numel() / 1e6:.1f} MB '
              f'read, the bf16 gradient {grad_bytes / 1e6:.1f} MB written), '
              f'{least / ms:.1%} of it; library call: none', flush=True)
        if not (same and rounded and ordered is not False and
                dtypes == {'torch.bfloat16'}):
            raise AssertionError(f'K12 bf16 ({kind}, B {b}) disagrees')
        if (b, kind) == (16, 'spread'):
            rows['roi_align_backward_bf16'] = kernel_row(
                err, ms, plain_ms, least, by)
        del d_out
        torch.cuda.empty_cache()
    return rows


def towers_gap(got, want):
    """The ImVoteNet towers' predictions against another run's, key by key
    over the three towers: {key: (max error over the tensor's largest, mean
    error over the tensor's mean magnitude)}, float32 against float32."""
    from demf_tpu_torch.models import imvotenet
    out = {}
    for key in ('vote_points', 'vote_features', 'aggregated_points',
                'obj_scores', 'sem_scores', 'distance', 'dir_class',
                'dir_res_norm'):
        worst = mean = 0.0
        for tower in imvotenet.TOWERS:
            g, w = got[tower][key].float(), want[tower][key].float()
            if not torch.isfinite(g).all():
                raise AssertionError(f'non-finite {tower} {key}')
            err = (g - w).abs()
            worst = max(worst, err.max().item() /
                        max(w.abs().max().item(), 1e-3))
            mean = max(mean, err.mean().item() /
                       max(w.abs().mean().item(), 1e-3))
        out[key] = (worst, mean)
    return out


def boxes_both_keep(got, got_valid, want, want_valid, iou=0.9):
    """How many of ``want``'s valid 2D boxes [xyxy, score, class] a valid
    box of ``got`` of the same class overlaps by ``iou`` or more."""
    from demf_tpu_torch.models.assign_sample import iou_2d
    ious = iou_2d(want[..., :4], got[..., :4])
    same = want[..., None, 5] == got[..., None, :, 5]
    hit = ((ious >= iou) & same & got_valid[..., None, :]).any(-1)
    return int((hit & want_valid).sum()), int(want_valid.sum())


def timed_requests(eval_step, batches, kernels, expected, label):
    """Each batch through ``eval_step``: its host ms, peak memory and
    launches (which must be ``expected``).  -> the host ms."""
    walls = []
    for i, batch in enumerate(batches):
        before = {n: k.launches for n, k in kernels.items()}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = eval_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launched = {n: k.launches - before[n] for n, k in kernels.items()}
        if launched != expected:
            raise AssertionError(f'{label} request {i} launched {launched}')
        if not all(torch.isfinite(det[k]).all() for k in ('boxes_3d',
                                                          'scores_3d')):
            raise AssertionError(f'{label} request {i}: non-finite')
        print(f'{label} request {i}: {walls[-1]:.3f} ms (host clock), '
              f'{int(det["valid"].sum())} valid detections, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, '
              f'launches {launched}', flush=True)
    return walls


def run_imvotenet_bf16(dev, kernels, f32_first):
    """ImVoteNet (``configs/baseline/imvotenet.py``, ``confident_imvotenet``)
    under the bf16 policy beside float32 in this run: 3 requests of batch
    2 in each (host ms, peak memory, launches: K11's bf16 entry under the
    policy), one more profiled in each (device ms, busy share); the bf16
    towers against float32 on the float32 run's 2D boxes within
    ``IMVOTENET_BF16_BOUND`` and the 2D boxes that both runs keep; 3 bf16
    stage-2 steps at 16 (launches, first step's losses within 0.2 of the
    float32 first step's, device ms a step).  Returns the launches by
    sub-path."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    from demf_tpu_torch.utils import precision
    bf16 = torch.bfloat16
    model, _ = confident_imvotenet(dev)
    batches = [batch_to_device(in_view(zoo.synth_demf_batch(
        seed=seed, **IMVOTENET_REQUEST)), dev) for seed in REQUESTS]
    by_path = {}
    for label, dtype, expected in (
            ('imvotenet f32', None, LAUNCHES_PER_IMVOTENET_REQUEST),
            ('imvotenet bf16', bf16, LAUNCHES_PER_IMVOTENET_REQUEST_BF16)):
        eval_step = make_eval_step(model, dtype)
        for k in kernels.values():
            k.launches = 0
        timed_requests(eval_step, batches, kernels, expected, label)
        if dtype is not None:
            by_path['imvotenet_serving_bf16'] = {
                n: k.launches for n, k in kernels.items()}
        profile_request(eval_step, batches[-1])
    batch = batches[0]
    with torch.inference_mode():
        want = precision.cast_floating(model(batch), torch.float32)
        boxes = (want['bboxes_2d'], want['bboxes_2d_valid'])
        own = precision.cast_floating(precision.policy_call(
            model, bf16, precision.cast_batch(batch, bf16)), torch.float32)
        saved = model.extract_bboxes_2d
        model.extract_bboxes_2d = lambda *a, **k: boxes
        try:
            got = precision.cast_floating(precision.policy_call(
                model, bf16, precision.cast_batch(batch, bf16)),
                torch.float32)
        finally:
            model.extract_bboxes_2d = saved
    gaps = towers_gap(got, want)
    mean = max(m for _, m in gaps.values())
    kept, total = boxes_both_keep(own['bboxes_2d'], own['bboxes_2d_valid'],
                                  *boxes)
    print(f'imvotenet bf16 against float32 (batch 2): towers on the float32 '
          f'run\'s 2D boxes, by key (max err over the tensor\'s largest / '
          f'mean err over its mean magnitude, worst tower): ' + ', '.join(
              f'{k} {w:.3e} / {m:.3e}' for k, (w, m) in gaps.items()) +
          f'; largest mean err {mean:.3e} (bound {IMVOTENET_BF16_BOUND}); '
          f'the bf16 run\'s own 2D boxes keep {kept} of the float32 run\'s '
          f'{total} (same class, IoU >= 0.9)', flush=True)
    if not (mean < IMVOTENET_BF16_BOUND and total and 2 * kept >= total):
        raise AssertionError('imvotenet bf16 against float32')
    del model, batches, batch, want, got, own
    torch.cuda.empty_cache()

    model, step = confident_imvotenet(dev, trainer=True, bf16=True)
    batch = batch_to_device(in_view(zoo.synth_batch_for(model, seed=0)),
                            dev)
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    for i in range(IMVOTENET_STEPS):
        start = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_IMVOTENET_STEP_BF16:
            raise AssertionError(f'imvotenet bf16 step {i} launched '
                                 f'{launched}')
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'imvotenet bf16 step {i}: non-finite')
        if i == 0:
            first = {k: v.item() for k, v in metrics.items()}
    by_path['imvotenet_step_bf16'] = {n: k.launches
                                      for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    worst = max(abs(first[k] - v) / max(abs(v), 1e-6)
                for k, v in f32_first.items() if k != 'grad_norm')
    found = kernels_a_call(lambda: step(batch, generator), {}, runs=2)
    b = IMVOTENET_STEP_BATCH[0]
    print(f'imvotenet bf16 step: batch {b}, the 2D branch in the step: ' +
          ', '.join(f'{t * 1e3:.3f}' for t in times) + ' ms (host clock), '
          f'after the first {b / np.mean(times[1:]):.3f} scenes/s; device '
          f'kernels {found["all"][0]:.3f} ms a step (tools.device_kernels, '
          f'{found["all"][1]} kernels), busy share '
          f'{found["all"][0] / (np.mean(times[1:]) * 1e3):.1%}; peak memory '
          f'{peak:.1f} MiB; first step\'s losses against float32\'s: max '
          f'rel err {worst:.3e} (bound 0.2)', flush=True)
    if not worst < 0.2:
        raise AssertionError('imvotenet bf16 step losses against float32')
    del model, step, batch
    torch.cuda.empty_cache()
    return by_path


def deformdetr_fusion_cfg():
    """``ImVoteNet_Deformdetr`` in its fusion mode at full width: the
    Deformable-DETR image branch of ``configs/deformdetr/imvotenet_deform.py``
    (frozen) with the point branch, image MLP, VoteFusion and three towers
    of ``configs/baseline/imvotenet.py``."""
    from demf_tpu_torch import zoo
    im = copy.deepcopy(zoo.load_model_cfg(IMVOTENET_CFG).model)
    detr = copy.deepcopy(zoo.load_model_cfg(PRETRAIN_CFG).model)
    cfg = {k: v for k, v in im.items() if k not in (
        'type', 'img_backbone', 'img_neck', 'img_rpn_head', 'img_roi_head',
        'train_cfg', 'test_cfg')}
    cfg.update(type='ImVoteNet_Deformdetr',
               img_backbone=detr['img_backbone'], img_neck=detr['img_neck'],
               img_bbox_head=detr['img_bbox_head'],
               train_cfg=dict(detr['train_cfg'], pts=im['train_cfg']['pts']),
               test_cfg=dict(detr['test_cfg'], pts=im['test_cfg']['pts']))
    return cfg


def run_deformdetr_fusion_bf16(dev, kernels):
    """One request of batch 2 x 20,000 points at 800x1344 of
    ``deformdetr_fusion_cfg`` under the bf16 policy (its DETR classifier's
    bias raised by 4, as the CPU tests raise it, so that 2D boxes pass its
    0.09 at random weights): launches, finite detections, host ms.
    Returns the launches."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    model = zoo.build_detector(deformdetr_fusion_cfg(), dev, seed=0)
    with torch.no_grad():
        model.img_bbox_head.fc_cls.bias.add_(4.0)
    batch = batch_to_device(in_view(zoo.synth_demf_batch(
        2, p=20000, hw=(800, 1344), valid_hw=(784, 1312), seed=4)), dev)
    eval_step = make_eval_step(model, torch.bfloat16)
    eval_step(batch)
    for k in kernels.values():
        k.launches = 0
    walls = timed_requests(eval_step, [batch], kernels,
                           LAUNCHES_DEFORMDETR_FUSION_BF16,
                           'deformdetr fusion bf16')
    with torch.inference_mode():
        _, valid = model.extract_bboxes_2d(batch['img'], batch['img_meta'])
    print(f'deformdetr fusion bf16: ImVoteNet_Deformdetr with points, '
          f'{sum(p.numel() for p in model.parameters())} parameters, '
          f'{walls[0]:.3f} ms a request after one untimed; 2D boxes over '
          f'0.09 a scene in float32 {valid.sum(1).tolist()}', flush=True)
    launches = {n: k.launches for n, k in kernels.items()}
    del model, batch, eval_step
    torch.cuda.empty_cache()
    return launches


def points_only(pipeline):
    """A train pipeline's point ops: what the cached stage-2 step's
    preprocess runs on the card (``bench.py``'s ``demf_devpipe``)."""
    ops = {'LoadPointsFromFile', 'LoadAnnotations3D', 'RandomFlip3D',
           'GlobalRotScaleTrans', 'PointSample', 'DefaultFormatBundle3D',
           'Collect3D'}
    return [t for t in pipeline if t['type'] in ops]


def compare_devpipe_step(model, step, batch, generator, kernels):
    """The DeMF stage-2 step at 16 x 20,000 on cached image features, in
    turns with the same step given the raw points (their first 3 columns,
    all 20,000 a scene) and ``TrainStep(preprocess=)`` on the config's
    point ops (height, flip, rotation and scale, the sample): host ms a
    step, launches."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.data import build_device_pipeline
    from demf_tpu_torch.engine.trainer import TrainStep
    from demf_tpu_torch.tools import time_ms
    cfg = zoo.load_model_cfg('demf/demf_votenet.py')
    p = batch['points'].shape[1]
    _, _, preprocess, _ = build_device_pipeline(
        points_only(cfg.data['train']['dataset']['pipeline']),
        points_cap=p, max_gt=64)
    raw = {k: v for k, v in batch.items() if k != 'points'}
    raw['raw_points'] = batch['points'][..., :3].contiguous()
    raw['raw_points_count'] = torch.full(
        (batch['points'].shape[0],), p, dtype=torch.int32,
        device=batch['points'].device)
    devpipe = TrainStep(model, step.optimizer, step.scheduler, step.max_norm,
                        preprocess=preprocess)
    times = {'cached': [], 'devpipe': []}
    for i in range(2 * 3 + 2):
        name = ('cached', 'devpipe')[i % 2]
        fn, b = (step, batch) if name == 'cached' else (devpipe, raw)
        start = {n: k.launches for n, k in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = fn(b, generator)
        torch.cuda.synchronize()
        if i >= 2:
            times[name].append((time.perf_counter() - t0) * 1e3)
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_STEP or not all(
                torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'{name} step launched {launched} or is '
                                 f'non-finite')
    pre_ms = time_ms(lambda: preprocess(raw, generator), 5)
    print(f'device pipeline: DeMF stage-2 step at {batch["points"].shape[0]}'
          f' x {p}, in turns after one of each: cached ' +
          ', '.join(f'{t:.3f}' for t in times['cached']) + ' ms, with '
          'preprocess= on the raw points ' +
          ', '.join(f'{t:.3f}' for t in times['devpipe']) + ' ms (host '
          f'clock; means {np.mean(times["cached"]):.3f} / '
          f'{np.mean(times["devpipe"]):.3f}); the points preprocess alone '
          f'{pre_ms:.4f} ms (CUDA events)', flush=True)


def loader_rate(dataset, workers, batch, collate_fn=None):
    """Scenes/s of the loader alone over the dataset (its threads, one
    pass)."""
    from demf_tpu_torch.data import build_dataloader
    loader = build_dataloader(dataset, samples_per_gpu=batch,
                              workers_per_gpu=workers, shuffle=True, seed=0,
                              collate_fn=collate_fn)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader) * batch
    return n / (time.perf_counter() - t0)


def run_device_pipeline(dev, kernels):
    """On-device preprocessing (``data/device_pipeline.py``, M7) on
    ``SyntheticSUNRGBD`` at the raw size (24,000 points, 480x640): the
    host pipeline's scenes/s against the raw loader's (``LoadRaw`` +
    ``collate_raw``) with the same workers, for DeMF's and ImVoteNet's
    train pipelines (``bench.py``'s ``loader_host`` / ``loader_raw``);
    ImVoteNet's whole train pipeline on the card at 16 (images and
    points): the preprocess's device ms, its images against the host
    pipeline's on the same scenes within 5 grey levels (the JAX test's
    5/57 at its std of 57; OpenCV resizes uint8 in fixed point), the
    matrix products without TF32; an epoch of ImVoteNet's stage-2 step
    through ``Runner`` on the raw loader + ``TrainStep(preprocess=)``
    against the host loader: each epoch's loader-wait share.  Returns the
    launches of the two epochs."""
    from demf_tpu_torch.data import (SyntheticSUNRGBD, build_dataloader,
                                     build_device_pipeline)
    from demf_tpu_torch.data.pipeline import Compose
    from demf_tpu_torch.engine import Runner, batch_to_device
    from demf_tpu_torch.engine.trainer import TrainStep
    from demf_tpu_torch.tools import time_ms
    from demf_tpu_torch.utils.config import Config
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('the device resize needs TF32 off')
    root = os.path.dirname(os.path.abspath(__file__))
    for cfg_file in (DATASET_CFG, IMVOTENET_DATASET_CFG):
        cfg = Config.fromfile(os.path.join(root, cfg_file))
        pipeline = cfg.data['train']['pipeline']
        workers, batch = cfg.data['workers_per_gpu'], cfg.data[
            'samples_per_gpu']
        host_load, collate_raw, _, _ = build_device_pipeline(
            pipeline, points_cap=24000, raw_img_hw=(480, 640))
        np.random.seed(0)
        host = loader_rate(SyntheticSUNRGBD(num_scenes=32, seed=0,
                                            pipeline=pipeline), workers,
                           batch)
        raw = loader_rate(SyntheticSUNRGBD(num_scenes=32, seed=0,
                                           pipeline=[host_load]), workers,
                          batch, collate_raw)
        print(f'device pipeline: {os.path.basename(cfg_file)}\'s train '
              f'pipeline on SyntheticSUNRGBD (24000 points, 480x640), '
              f'{workers} workers, batches of {batch}: host pipeline '
              f'{host:.3f} scenes/s, raw loader (LoadRaw + collate_raw) '
              f'{raw:.3f} scenes/s', flush=True)

    # ImVoteNet's train pipeline on the card, against the host's images
    pipeline = cfg.data['train']['pipeline']
    host_load, collate_raw, preprocess, spec = build_device_pipeline(
        pipeline, points_cap=24000, raw_img_hw=(480, 640))
    scenes = SyntheticSUNRGBD(num_scenes=16, seed=0)
    raw = batch_to_device(collate_raw([host_load(scenes[i])
                                       for i in range(16)]), dev)
    generator = torch.Generator(dev).manual_seed(0)
    out = preprocess(raw, generator)
    ms = time_ms(lambda: preprocess(raw, generator), 5)
    host = Compose(pipeline)
    worst = 0.0
    for i in range(16):
        np.random.seed(i)
        want = host(scenes[i])
        img = np.asarray(want['img'])
        nh, nw = out['img_meta']['img_shape'][i].tolist()
        if (nh, nw) != tuple(want['img_meta']['img_shape'][:2]) or \
                out['img'][i, nh:].abs().max() > 0 or \
                out['img'][i, :, nw:].abs().max() > 0:
            raise AssertionError('device image shape or pad')
        got = out['img'][i, :nh, :nw].cpu().numpy()
        worst = max(worst, float(np.abs(got - img[:nh, :nw]).max()))
    bound = 5.0 / float(spec.norm_std.min())
    print(f'device pipeline: ImVoteNet\'s train pipeline on the card, batch '
          f'16 raw (24000 points, 480x640 uint8) -> points '
          f'{tuple(out["points"].shape)}, images {tuple(out["img"].shape)}: '
          f'{ms:.4f} ms on the device (CUDA events, TF32 off); images '
          f'against the host pipeline\'s, max |device - host| {worst:.4f} '
          f'(bound {bound:.4f}: 5 grey levels)', flush=True)
    if not worst <= bound:
        raise AssertionError('device images differ from the host pipeline')

    # an epoch of ImVoteNet's step on each loader
    model, step = confident_imvotenet(dev, trainer=True)
    devpipe = TrainStep(model, step.optimizer, step.scheduler, step.max_norm,
                        preprocess=preprocess)
    workers, batch = cfg.data['workers_per_gpu'], cfg.data['samples_per_gpu']
    shares, launches = {}, {}
    for name in ('host', 'devpipe'):
        if name == 'host':
            loader = build_dataloader(
                SyntheticSUNRGBD(num_scenes=32, seed=0, pipeline=pipeline),
                samples_per_gpu=batch, workers_per_gpu=workers, seed=0)
            train_step = step
        else:
            loader = build_dataloader(
                SyntheticSUNRGBD(num_scenes=32, seed=0,
                                 pipeline=[host_load]),
                samples_per_gpu=batch, workers_per_gpu=workers, seed=0,
                collate_fn=collate_raw)
            train_step = devpipe
        for k in kernels.values():
            k.launches = 0
        np.random.seed(0)
        runner = Runner(model, step.optimizer, train_step, loader,
                        max_epochs=1, log_interval=1000, logger=lambda m: None)
        runner.run()
        launches[name] = {n: k.launches for n, k in kernels.items()}
        if launches[name] != {n: 2 * c for n, c in
                              LAUNCHES_PER_IMVOTENET_STEP.items()}:
            raise AssertionError(f'{name} epoch launched {launches[name]}')
        shares[name] = runner.loader_wait_s / runner.epoch_s
        print(f'device pipeline: an epoch of ImVoteNet\'s step (32 scenes, '
              f'2 steps at {batch}) on the {name} loader: '
              f'{runner.epoch_s:.3f} s, of which {runner.loader_wait_s:.3f} '
              f's ({shares[name]:.1%}) waiting for the loader', flush=True)
    del model, step, devpipe, raw, out
    torch.cuda.empty_cache()
    return {f'devpipe_epoch_{k}': v for k, v in launches.items()}


def run_frcnn_bf16(dev, kernels, f32_first):
    """The image-only Faster R-CNN under the bf16 policy (bf16 FPN levels:
    K11 and K12 through their bf16 entries), at ``FRCNN_SMOKE_LR`` from
    the float32 run's weights and batch: 3 steps at 16 x 608x832 with 512
    RoIs an image (host ms, launches: K10, K11 bf16 and K12 bf16 once a
    step), the first step's losses within 0.2 of the float32 first
    step's, K11's and K12's device ms a step (``tools.device_kernels``),
    and a request of batch 2 (K10 twice, K11 bf16 once).  Returns the
    launches by sub-path."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    cfg = frcnn_cfg()
    cfg.optimizer['lr'] = FRCNN_SMOKE_LR
    cfg['bf16'] = True
    model, _, step = zoo.build_trainer(cfg, dev, seed=0)
    batch = batch_to_device(zoo.synth_batch_for(model, seed=0), dev)
    generator = torch.Generator(dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    for i in range(FRCNN_STEPS):
        start = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_FRCNN_STEP_BF16:
            raise AssertionError(f'frcnn bf16 step {i} launched {launched}')
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'frcnn bf16 step {i}: non-finite')
        if i == 0:
            first = {k: v.item() for k, v in metrics.items()}
    by_path = {'frcnn_step_bf16': {n: k.launches
                                   for n, k in kernels.items()}}
    peak = torch.cuda.max_memory_allocated() / 2**20
    worst = max(abs(first[k] - v) / max(abs(v), 1e-6)
                for k, v in f32_first.items() if k != 'grad_norm')
    terms = ', '.join(f'{k} {first[k]:.4f} ({f32_first[k]:.4f})'
                      for k in f32_first)
    b = FRCNN_STEP_BATCH[0]
    print(f'frcnn bf16 step: batch {b} x {FRCNN_STEP_BATCH[1]}x'
          f'{FRCNN_STEP_BATCH[2]}, {FRCNN_ROIS} RoIs an image: ' +
          ', '.join(f'{t * 1e3:.3f}' for t in times) + ' ms (host clock), '
          f'after the first {b / np.mean(times[1:]):.3f} images/s; peak '
          f'memory {peak:.1f} MiB; first step (float32\'s): {terms}; max '
          f'rel err {worst:.3e} (bound 0.2)', flush=True)
    if not worst < 0.2:
        raise AssertionError('frcnn bf16 losses against float32')
    found = frcnn_step_kernels('frcnn bf16', step, batch, generator)
    print(f'frcnn bf16 step: busy share '
          f'{found["all"][0] / (np.mean(times[1:]) * 1e3):.1%} (device '
          f'kernels over the host clock)', flush=True)
    del step, batch
    torch.cuda.empty_cache()
    model.eval()
    batch = batch_to_device(zoo.synth_batch_for(model, b=2, seed=3), dev)
    eval_step = make_eval_step(model, torch.bfloat16)
    with torch.inference_mode():
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = eval_step(batch)
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
    launched = {n: k.launches for n, k in kernels.items()}
    by_path['frcnn_request_bf16'] = launched
    print(f'frcnn bf16 request: batch 2 x 608x832, {latency:.3f} ms (host '
          f'clock, the first at this shape), {int(det["valid"].sum())} valid '
          f'2D detections, float32: {det["bboxes"].dtype}; launches '
          f'{launched}', flush=True)
    if launched != LAUNCHES_PER_FRCNN_REQUEST_BF16 or \
            det['bboxes'].dtype != torch.float32 or \
            not torch.isfinite(det['bboxes']).all():
        raise AssertionError('frcnn bf16 request')
    del model, batch, det
    torch.cuda.empty_cache()
    return by_path

# -- the FCAF3D family served: K13 kernel map, K14 sparse conv, K15 NMS ------

FCAF3D_CFG = 'fcaf3d/fcaf3d_sunrgbd.py'
DEMF_FCAF3D_CFG = 'demf/demf_fcaf3d.py'
FCAF3D_POINTS = 100000
FCAF3D_EVAL_SCENES = 8
# a request's launches: 7 kernel-map launches for its 13 tables (the
# stem's, the pool's, one a stage for its strided table and its level's
# 27-tap table, whose tap 0 the shortcut reads; one for the head's 3 parent
# lookups), 47 sparse convs (the stem, 36 in MinkResNet34, 2 an up block
# and 1 an out block; K14's count is one a call, whose tiles kernel is
# followed by its sum of parts where the taps are split) on the row plans
# of their 16 tables (the stem's, 3 a stage, one an up block), one
# class-wise NMS (its pairs kernel and its sweep kernel), the stem's max
# pool (K17 on the pool's table, in the rows' dtype); DeMF-FCAF3D adds
# the encoder's 6 MSDA layers (uncached) and its decoder's one
SPARSE_PATH = dict(kernel_map=7, sparse_conv=47, sparse_conv_plan=16,
                   nms3d_rotated=1, sparse_max_pool=1)
LAUNCHES_PER_FCAF3D_REQUEST = launch_counts(**SPARSE_PATH)
LAUNCHES_PER_FCAF3D_REQUEST_BF16 = launch_counts(
    kernel_map=7, sparse_conv_bf16=47, sparse_conv_plan=16,
    nms3d_rotated=1, sparse_max_pool_bf16=1)
LAUNCHES_PER_DEMF_FCAF3D_REQUEST = launch_counts(msda=7, **SPARSE_PATH)
LAUNCHES_PER_DEMF_FCAF3D_CACHED = launch_counts(msda=1, **SPARSE_PATH)
# a train step's launches: the forward's (a request's without K15), then in
# the backward K14 on the reverse table of every convolution whose input
# takes a gradient (all 47 but the stem's, whose colours take none), K16 on
# every convolution's table, and the reverse tables: each stage's parent
# table (4 K13 launches, its tap 0 the shortcut's reverse) and the plans of
# 12 reverse tables (the 4 level tables flipped, the 4 parent tables and
# their 4 one-tap cuts); the up blocks' transposed convs read back the 3
# strided tables on the plans their forward made; the stem pool's
# backward (K17's, on its forward's tie mask and reverse index)
SPARSE_TRAIN_STEP = dict(kernel_map=11, sparse_conv=47,
                         sparse_conv_backward=46, sparse_conv_plan=28,
                         sparse_conv_dweights=47, sparse_max_pool=1,
                         sparse_max_pool_backward=1)
LAUNCHES_PER_FCAF3D_STEP = launch_counts(**SPARSE_TRAIN_STEP)
# the decoder's one MSDA layer, forward and backward
LAUNCHES_PER_DEMF_FCAF3D_STEP = launch_counts(msda=1, msda_backward=1,
                                              **SPARSE_TRAIN_STEP)
# under the bf16 policy the same launches on the bf16 entries: the voxel
# features go to bf16 before the stem, so every convolution's rows, its
# output gradient and its reverse-table call are bf16; the decoder's MSDA
# reads a bf16 value
SPARSE_TRAIN_STEP_BF16 = dict(kernel_map=11, sparse_conv_bf16=47,
                              sparse_conv_backward_bf16=46,
                              sparse_conv_plan=28,
                              sparse_conv_dweights_bf16=47,
                              sparse_max_pool_bf16=1,
                              sparse_max_pool_backward_bf16=1)
LAUNCHES_PER_FCAF3D_STEP_BF16 = launch_counts(**SPARSE_TRAIN_STEP_BF16)
LAUNCHES_PER_DEMF_FCAF3D_STEP_BF16 = launch_counts(
    msda_bf16=1, msda_backward_bf16=1, **SPARSE_TRAIN_STEP_BF16)
# a FCAF3D request's tables (13, in the 7 launches above)
FCAF3D_TABLES = 13
FCAF3D_MARKERS = {'K13': ('kernel_map_kernel',),
                  'K14': ('sparse_conv_tiles', 'sparse_conv_sum_parts',
                          'sparse_conv_plan'),
                  'K15': ('nms3d_pairs_kernel', 'nms3d_sweep_kernel'),
                  'K17': ('pool_forward_kernel',),
                  'K3': ('msda_forward_kernel',)}
# an IoU this close to iou_thr may fall on either side between two
# roundings of the same pair: a keep bit it decides may differ
IOU_THR_BAND = 1e-5
# bf16 against float32 per-voxel predictions of a full-width FCAF3D
# request, of each tensor's largest (the exp of the box regression through
# 34 bf16 layers leads): 0.1008 on an H100.  The run prints the readings
# the bound sits between: under it the policy on the request and on the
# eval batch (they must be), beside the policy through the plain path;
# over it a control whose K14 rows and weights are rounded to float8 e4m3
# (4 significant bits where bf16 keeps 8; it must be).  At the tiny size
# on the CPU the port's own gap is within 0.55-1.6x the JAX package's
# (tests/test_torch_fcaf3d.py)
FCAF3D_BF16_BOUND = 0.2
# operations of one rotated IoU (the corners, 8 inside tests, 16 edge
# crossings, 24 angles sorted, the area; counted from the kernel's source).
# K15's bound counts one IoU a pair of distinct boxes that take part in
# some class's sweep (valid, a score above score_thr) and can meet (the
# pairs apart, ``tools/nms_cases.py::rotated_pairs_apart``, cost no clip):
# IoU is symmetric
IOU_PAIR_OPS = 600
# K15's sweep floor: one class's N dependent steps of ~8 clocks at the
# card's 1,980 MHz (K8's row in PERF.md counts its sweep so)
SWEEP_STEP_CLOCKS = 8
SM_CLOCK_HZ = 1.98e9
# K15's IoUs against iou3d_matrix's at room coordinates (within ~10 m of
# the origin): 1e-6 for two distinct boxes.  A box and a copy of itself
# (the diagonal, and coincident boxes of other indices, which decide NMS)
# have parallel edges whose crossings both versions compute from
# denominators of rounding noise: up to 2.5e-6 on a request and 4.8e-7 on
# the synthetic cases on an H100, held to 1e-5.  Boxes hundreds of metres
# out are a case of their own in the card tests
# (test_rotated_nms_far_from_the_origin)
K15_COPY_TOL = 1e-5


def patched(*changes):
    """Module attributes set until the returned stack closes: (module,
    name, value)."""
    stack = contextlib.ExitStack()
    for module, name, value in changes:
        stack.enter_context(mock.patch.object(module, name, value))
    return stack


def plain_sparse_ops():
    """The FCAF3D family's K13, K14 with its plan (forward, and on reverse
    tables in the backward), K16, K17 (the chain of ``torch.maximum`` and
    its autograd), K15 and the decoders' MSDA routed to their plain
    versions."""
    from demf_tpu_torch.models import fcaf3d, transformer
    from demf_tpu_torch.ops import msda, nms_rotated, sparse
    return patched(
        (sparse, 'kernel_tables_cuda',
         lambda jobs: [sparse.kernel_table_plain(j) for j in jobs]),
        (sparse, 'conv_plan', sparse.conv_plan_plain),
        (sparse, 'sparse_conv_cuda',
         lambda feats, nbr, w, plan: sparse.sparse_conv_plain(feats, nbr, w)),
        (sparse, 'sparse_conv_backward_cuda',
         lambda g, rev, wt, plan: sparse.sparse_conv_plain(g, rev, wt)),
        (sparse, 'sparse_conv_dweights_cuda',
         lambda feats, nbr, g, plan: sparse.sparse_conv_dweights_plain(
             feats, nbr, g)),
        (sparse, 'sparse_max_pool', sparse.sparse_max_pool_plain),
        (fcaf3d, 'rotated_nms_classwise',
         nms_rotated.rotated_nms_classwise_plain),
        (transformer, 'multi_scale_deformable_attention', msda.msda_plain))


@contextlib.contextmanager
def recorded_calls():
    """Keep the arguments of every K13, K14 (forward and on reverse
    tables), K16, K17 (forward and backward), K15 and K18 launch in the
    block (yielded by kernel): the shapes and data the main path gives
    them."""
    from demf_tpu_torch.ops import nms_rotated, sparse, vote_targets
    calls = {'kernel_map': [], 'sparse_conv': [], 'nms3d_rotated': [],
             'sparse_conv_backward': [], 'sparse_conv_dweights': [],
             'sparse_max_pool': [], 'sparse_max_pool_backward': [],
             'vote_targets': []}

    def recorder(module, name, key):
        fn = getattr(module, name)

        def call(*args):
            calls[key].append(args)
            return fn(*args)
        return module, name, call

    with patched(recorder(sparse, 'kernel_tables_cuda', 'kernel_map'),
                 recorder(sparse, 'sparse_conv_cuda', 'sparse_conv'),
                 recorder(sparse, 'sparse_conv_backward_cuda',
                          'sparse_conv_backward'),
                 recorder(sparse, 'sparse_conv_dweights_cuda',
                          'sparse_conv_dweights'),
                 recorder(sparse, 'sparse_max_pool_cuda', 'sparse_max_pool'),
                 recorder(sparse, 'sparse_max_pool_backward_cuda',
                          'sparse_max_pool_backward'),
                 recorder(nms_rotated, 'rotated_nms_classwise_cuda',
                          'nms3d_rotated'),
                 recorder(vote_targets, 'vote_targets_cuda',
                          'vote_targets')):
        yield calls


def check_kernel_map(calls):
    """K13 on a request's launches (its 13 tables in 7) against its plain
    version (equal, each table also equal to the same table made alone),
    timed over all of them beside one ``torch.searchsorted`` a table over
    the flattened query keys plus the equality test (the yardstick).  Its
    bound: each coordinate and valid tensor of the request read once, the
    tables written once (bytes); beside it the time of a one-lookup launch
    times the launches, the least that a chain of launches in stream order
    takes."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import bound_ms, time_ms
    lookups = nbytes = ops = tables = 0
    keys = []
    # each coordinate and valid tensor read once a request, however many
    # jobs read it (a level's coordinates are the keys and queries of its
    # own table and the queries or keys of the next level's)
    inputs = {}
    for (jobs,) in calls:
        got = sparse.kernel_tables_cuda(jobs)
        for job, table in zip(jobs, got):
            want = sparse.kernel_table_plain(job)
            if not (torch.equal(table, want) and torch.equal(
                    table, sparse.kernel_tables_cuda([job])[0])):
                raise AssertionError(f'K13 table {tuple(table.shape)} '
                                     f'differs from plain')
            tables += 1
            lookups += table.numel() if not job.cell else table.shape[1] * \
                table.shape[0]
            for t in (job.coords, job.valid, job.query_coords,
                      job.query_valid):
                inputs[t.data_ptr()] = max(inputs.get(t.data_ptr(), 0),
                                           t.numel() * t.element_size())
            nbytes += table.numel() * 4
            ops += table.numel() * (12 + 2 * int(np.ceil(np.log2(
                job.valid.shape[1] + 1))))
            skeys = sparse.key_table_presorted(job.coords, job.valid)[0]
            base = job.query_coords if not job.cell else torch.div(
                job.query_coords, job.cell, rounding_mode='floor') * job.cell
            offs = sparse.kernel_offsets(
                job.kernel_size if not job.cell else 1, job.me_order,
                skeys.device) * job.stride
            q = (base[:, :, None] + offs).clamp(0, sparse.MAX_COORD)
            keys.append((skeys, sparse.linearize(q).reshape(
                skeys.shape[0], -1)))
    if tables != FCAF3D_TABLES:
        raise AssertionError(f'K13: {tables} tables a request, expected '
                             f'{FCAF3D_TABLES}')
    nbytes += sum(inputs.values())
    one = [sparse.one_lookup(calls[0][0][0])]

    def kernel():
        for (jobs,) in calls:
            sparse.kernel_tables_cuda(jobs)

    def plain():
        for (jobs,) in calls:
            for j in jobs:
                sparse.kernel_table_plain(j)

    def library():
        for skeys, qk in keys:
            pos = torch.searchsorted(skeys, qk).clamp(max=skeys.shape[1] - 1)
            _ = skeys.gather(1, pos) == qk

    ms, plain_ms, lib_ms = (time_ms(kernel, 20), time_ms(plain, 5),
                            time_ms(library, 20))
    one_ms = time_ms(lambda: sparse.kernel_tables_cuda(one), 50)
    least, by = bound_ms(ops, nbytes)
    print(f'K13 kernel_map: {tables} tables of a request in {len(calls)} '
          f'launches, {lookups} lookups, equal to plain and to each table '
          f'made alone; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'searchsorted + equality {lib_ms:.4f} ms, bound {least:.6f} ms '
          f'({by}); a one-lookup launch {one_ms:.4f} ms, x {len(calls)} '
          f'launches {one_ms * len(calls):.4f} ms')
    return kernel_row(0, ms, plain_ms, least, by, lib_ms)


def check_sparse_conv(calls, dtype, label='a request'):
    """K14 on a request's 47 convolutions (their own features, tables, row
    plans and weights; in bf16 the same rounded) against its plain version:
    float32 within 1e-5 of each output's largest, bf16 within one bf16 step
    of it, the same bits on two calls.  Timed over all of them with the
    plans of their tables made anew (a plan counts with the kernel), beside
    one gather of (M, K * C) and one ``torch.matmul`` a convolution (the
    yardstick); the plans' time alone is printed.  The operations of the
    taps that exist are printed beside those K14 computes on its tiles.
    Its bound counts the taps that exist, at the peak of their operands'
    type: float32 outside the tensor cores, bf16 on them (float32 sums, as
    K14 keeps).  The float32 entry also prints a second bound at the rate
    of what it runs, 3xTF32: three TF32 products a multiply-add on the
    tensor cores, TF32's dense peak over 3 (or the bytes, if larger)."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import (PEAK_BF16_FLOPS, PEAK_FLOPS,
                                      PEAK_TF32_FLOPS, bound_ms, time_ms)
    from demf_tpu_torch.tools.sparse_cases import (conv_flops,
                                                   gather_matmul, tolerance)
    size = torch.finfo(dtype).bits // 8
    tables = {}
    for _, nbr, _, plan in calls:
        tables.setdefault(id(plan), nbr)
    keys = list(tables)
    calls = [(f.to(dtype), n, w.to(dtype), plan, keys.index(id(plan)))
             for f, n, w, plan in calls]
    worst = flops = computed = nbytes = 0.0
    gathers = []
    for feats, nbr, w, plan, _ in calls:
        got = sparse.sparse_conv_cuda(feats, nbr, w, plan)
        if not torch.equal(got, sparse.sparse_conv_cuda(feats, nbr, w,
                                                        plan)):
            raise AssertionError(f'K14 {dtype} {tuple(nbr.shape)}: other '
                                 f'bits on a second call')
        want = sparse.sparse_conv_plain(feats, nbr, w).float()
        top = max(want.abs().max().item(), 1e-30)
        err = (got.float() - want).abs().max().item()
        tol = tolerance(want, dtype)
        if not err <= tol:
            raise AssertionError(f'K14 {dtype} {tuple(nbr.shape)} x '
                                 f'{tuple(w.shape)}: {err} above {tol}')
        worst = max(worst, err / top)
        existing, work = conv_flops(nbr, plan, feats.shape[2], w.shape[2])
        flops += existing
        computed += work
        nbytes += (feats.numel() + w.numel() + got.numel()) * size + \
            nbr.numel() * 4
        gathers.append(gather_matmul(feats, nbr, w))
    nbrs = list(tables.values())

    def plans():
        return [sparse.conv_plan(n) for n in nbrs]

    def kernel():
        made = plans()
        for feats, nbr, w, _, t in calls:
            sparse.sparse_conv_cuda(feats, nbr, w, made[t])

    def plain():
        for feats, nbr, w, _, _ in calls:
            sparse.sparse_conv_plain(feats, nbr, w)

    def library():
        for fn in gathers:
            fn()

    ms, plan_ms, plain_ms, lib_ms = (time_ms(kernel, 5), time_ms(plans, 5),
                                     time_ms(plain, 2), time_ms(library, 5))
    least, by = bound_ms(flops, nbytes, PEAK_FLOPS if dtype == torch.float32
                         else PEAK_BF16_FLOPS)
    if dtype == torch.float32:
        tf32, tf32_by = bound_ms(flops, nbytes, PEAK_TF32_FLOPS / 3)
        print(f'K14 sparse_conv float32 beside its 3xTF32 bound: kernel '
              f'{ms:.4f} ms, bound at TF32\'s {PEAK_TF32_FLOPS / 1e12:.0f} '
              f'TFLOP/s over 3 {tf32:.6f} ms ({tf32_by}): '
              f'{tf32 / ms:.1%} of it (the pinned bound {least:.6f} ms: '
              f'{least / ms:.1%})')
    print(f'K14 sparse_conv {str(dtype)[6:]}: {len(calls)} convolutions of '
          f'{label} on {len(nbrs)} tables, {flops / 1e9:.3f} GFLOP of '
          f'existing taps, {computed / 1e9:.3f} GFLOP computed on the '
          f'plans\' tiles, max rel err {worst:.3e}, the same bits twice; '
          f'kernel {ms:.4f} ms with the plans made anew (the plans alone '
          f'{plan_ms:.4f} ms), plain {plain_ms:.4f} ms, gather + matmul '
          f'{lib_ms:.4f} ms, bound {least:.6f} ms ({by}; '
          f'{flops / 1e9 / max(ms, 1e-9):.1f} TFLOP/s of existing taps)')
    return kernel_row(worst, ms, plain_ms, least, by, lib_ms)


def check_conv_plans(calls):
    """K14's plan kernel on the request's tables (one a table, however
    many convolutions read it): mask, order and tile taps equal to
    ``conv_plan_plain``'s; timed over the tables beside the plain plans.
    Its bound: the tables read once, the plans written once (bytes)."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import bound_ms, time_ms
    tables = {}
    for _, nbr, _, plan in calls:
        tables.setdefault(id(plan), nbr)
    nbrs = list(tables.values())
    nbytes = 0
    for nbr in nbrs:
        got, want = sparse.conv_plan_cuda(nbr), sparse.conv_plan_plain(nbr)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f'K14 plan of {tuple(nbr.shape)} differs '
                                 f'from plain')
        nbytes += 4 * (nbr.numel() + sum(t.numel() for t in got))
    ms = time_ms(lambda: [sparse.conv_plan_cuda(n) for n in nbrs], 10)
    plain_ms = time_ms(lambda: [sparse.conv_plan_plain(n) for n in nbrs], 5)
    least, by = bound_ms(0, nbytes)
    print(f'K14 sparse_conv_plan: {len(nbrs)} tables of a request, equal to '
          f'plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{least:.6f} ms ({by})')
    return kernel_row(0, ms, plain_ms, least, by)


def time_sparse_levels(dev):
    """K14 off the request's own scenes (``tools/sparse_cases.py``): a
    dense cube (every tap inside it exists: the plan saves nothing) and a
    scattered level (few taps a row) at layers 1, 3 and 4's widths, batch
    2, float32 and bf16: within the request's tolerances of the plain
    version; the existing and the computed GFLOP, its ms with the plan
    made anew beside the gather + matmul yardstick's."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import time_ms
    from demf_tpu_torch.tools.sparse_cases import (SPARSE_LEVELS,
                                                   conv_flops,
                                                   gather_matmul, level,
                                                   tolerance)
    for kind, b, m, c, co in SPARSE_LEVELS:
        nbr, m_in = level(dev, kind, b, m)
        plan = sparse.conv_plan(nbr)
        gen = torch.Generator(dev).manual_seed(m + c)
        feats32 = torch.randn(b, m_in, c, device=dev, generator=gen)
        w32 = torch.randn(27, c, co, device=dev, generator=gen) / \
            (27 * c) ** 0.5
        existing, computed = conv_flops(nbr, plan, c, co)
        for dtype in (torch.float32, torch.bfloat16):
            feats, w = feats32.to(dtype), w32.to(dtype)
            got = sparse.sparse_conv_cuda(feats, nbr, w, plan)
            want = sparse.sparse_conv_plain(feats, nbr, w)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tolerance(want, dtype):
                raise AssertionError(f'K14 {kind} {dtype}: {err}')
            ms = time_ms(lambda: sparse.sparse_conv_cuda(
                feats, nbr, w, sparse.conv_plan(nbr)), 10)
            lib_ms = time_ms(gather_matmul(feats, nbr, w), 10)
            print(f'K14 sparse_conv {str(dtype)[6:]} on a {kind} level (B '
                  f'{b}, M {m}, {c} -> {co}, K 27): {existing / 1e9:.3f} '
                  f'GFLOP of existing taps, {computed / 1e9:.3f} computed; '
                  f'kernel {ms:.4f} ms with its plan, gather + matmul '
                  f'{lib_ms:.4f} ms ({existing / 1e9 / ms:.1f} TFLOP/s of '
                  f'existing taps)', flush=True)


def check_nms3d_rotated(calls):
    """K15 on a request's call: its IoUs (asked for) within 1e-6 of
    ``iou3d_matrix``'s for two distinct boxes and within ``K15_COPY_TOL``
    for a box and a copy of itself, exactly 0 as the plain version's for
    the pairs that cannot meet, its masks equal to the plain sweep fed its
    own IoUs and to those of the model path's call (no IoU asked for);
    then on spread, piled, coincident, apart and far boxes at the same
    shape.  Timed as the model calls it (its two kernels' device ms come
    from the request profiles: deep in this script torch.profiler records
    no event of so short a call); its bound counts the pairs that take part
    and can meet, beside its sweep floor (N dependent steps of
    ``SWEEP_STEP_CLOCKS``)."""
    from demf_tpu_torch.core.rotated_iou import iou3d_matrix
    from demf_tpu_torch.ops import nms_rotated
    from demf_tpu_torch.tools import bound_ms, time_ms
    from demf_tpu_torch.tools.nms_cases import (rotated_nms_case,
                                                rotated_pairs_apart)
    boxes, scores, valid, iou_thr, score_thr = calls[0]
    b, n, c = scores.shape
    cases = [('request', boxes, scores, valid)] + [
        (kind, *(torch.from_numpy(a).to(boxes.device) for a in
                 rotated_nms_case(kind, b, n, c, seed=1)))
        for kind in ('spread', 'piled', 'coincident', 'apart', 'far')]
    iou_err = 0.0
    for kind, bx, sc, va in cases:
        iou = torch.empty((b, n, n), device=bx.device)
        keep = nms_rotated.rotated_nms_classwise_cuda(
            bx, sc, va, iou_thr, score_thr, iou)
        model = nms_rotated.rotated_nms_classwise_cuda(
            bx, sc, va, iou_thr, score_thr)
        plain_iou = iou3d_matrix(bx, bx)
        err = (iou - plain_iou).abs()
        copies = (bx[:, :, None] == bx[:, None]).all(-1)
        apart = rotated_pairs_apart(bx)
        copy_err = err[copies].max().item()
        differ = int((keep != nms_rotated.classwise_sweep(
            iou, sc, va, iou_thr, score_thr)).sum())
        print(f'K15 nms3d_rotated ({b}, N {n}, {c} classes, {kind}): kept '
              f'{int(keep.sum())}, {differ} bits differ from the plain sweep '
              f'on its IoUs, {int((model != keep).sum())} from the model '
              f'path\'s call; IoU max abs err '
              f'{err[~copies].max().item():.3e} (a box and its copy '
              f'{copy_err:.3e}); {int(apart.sum())} of {b * n * n} pairs '
              f'cannot meet, their IoUs exactly 0: '
              f'{bool((iou[apart] == 0).all() and (plain_iou[apart] == 0).all())}')
        if kind == 'far':
            # corners hundreds of metres out: a box and its copy within
            # 4 R 2^-23 over the smallest side (test_rotated_nms_far_from_
            # the_origin); distinct boxes as everywhere
            copy_tol = 4 * bx[..., :2].abs().max().item() * 2.0 ** -23 / 0.3
        else:
            copy_tol = K15_COPY_TOL
            iou_err = max(iou_err, err[~copies].max().item())
        if differ or not torch.equal(model, keep) or \
                not err[~copies].max().item() <= 1e-6 or \
                not copy_err <= copy_tol or not (iou[apart] == 0).all() or \
                not (plain_iou[apart] == 0).all():
            raise AssertionError('K15 differs from its plain version')
    args = calls[0]
    ms = time_ms(lambda: nms_rotated.rotated_nms_classwise_cuda(*args), 20)
    plain_ms = time_ms(
        lambda: nms_rotated.rotated_nms_classwise_plain(*args), 2)
    part = valid & (scores > score_thr).any(-1)
    both = (part[:, :, None] & part[:, None]).triu(1)
    pairs = int(both.sum())
    meet = int((both & ~rotated_pairs_apart(boxes)).sum())
    least, by = bound_ms(IOU_PAIR_OPS * meet,
                         boxes.numel() * 4 + scores.numel() * 4 +
                         valid.numel() + b * c * n)
    sweep_ms = n * SWEEP_STEP_CLOCKS / SM_CLOCK_HZ * 1e3
    print(f'K15 nms3d_rotated at the request: kernel {ms:.4f} ms through '
          f'its wrapper (its device ms: the request profiles), plain '
          f'{plain_ms:.4f} ms, bound {least:.6f} ms ({by}; {pairs} pairs of '
          f'boxes that take part, {meet} of them can meet), sweep floor '
          f'{sweep_ms:.6f} ms ({n} dependent steps)')
    return kernel_row(iou_err, ms, plain_ms, least, by)


def level_errors(got, want, keys=('centerness', 'bbox_pred', 'cls_scores'),
                 strict=True):
    """Max error over each per-voxel output's largest, over the levels and
    the fused stages.  A non-finite output raises, or with ``strict``
    False counts as an infinite error."""
    worst = 0.0
    pools = list(got['head_outs']) + list(got.get('fusion_stages', []))
    ref = list(want['head_outs']) + list(want.get('fusion_stages', []))
    for g, w in zip(pools, ref):
        for key in keys:
            if not torch.isfinite(g[key]).all():
                if not strict:
                    return float('inf')
                raise AssertionError(f'non-finite {key}')
            scale = max(w[key].float().abs().max().item(), 1e-3)
            worst = max(worst, (g[key].float() - w[key].float()).abs().max()
                        .item() / scale)
    return worst


def compare_sparse_paths(model, batch, label):
    """The kernel path against the plain path on a full-width request:
    per-voxel predictions within 2e-3 relative; the keep masks of K15 and
    of the plain NMS on the kernel path's candidates equal, or each
    differing bit that of a box in a pair whose IoU lies within
    ``IOU_THR_BAND`` of iou_thr."""
    from demf_tpu_torch.ops import nms_rotated
    head = model.head
    tcfg = head.test_cfg
    with torch.inference_mode():
        got = model(batch)
        with plain_sparse_ops():
            want = model(batch)
        boxes, probs, valid = head.candidates(head.pools(got))
        iou = torch.empty(valid.shape + valid.shape[-1:], device=valid.device)
        keep = nms_rotated.rotated_nms_classwise_cuda(
            boxes, probs, valid, tcfg['iou_thr'], tcfg['score_thr'], iou)
        plain = nms_rotated.rotated_nms_classwise_plain(
            boxes, probs, valid, tcfg['iou_thr'], tcfg['score_thr'])
    worst = level_errors(got, want)
    near = ((iou - tcfg['iou_thr']).abs() <= IOU_THR_BAND) & \
        valid[:, :, None] & valid[:, None, :]
    differ = keep != plain
    in_near_pair = (near.any(2) | near.any(1))[:, None, :]
    unexplained = int((differ & ~in_near_pair).sum())
    print(f'{label}: kernel path vs plain path, max rel err {worst:.3e} '
          f'(bound 2e-3); K15 vs plain NMS on the same candidates: kept '
          f'{int(keep.sum())} / {int(plain.sum())}, {int(differ.sum())} '
          f'bits differ, {int(near.sum())} pairs within {IOU_THR_BAND} of '
          f'iou_thr, {unexplained} differences unexplained', flush=True)
    if not worst < 2e-3 or unexplained:
        raise AssertionError(f'{label}: kernel path disagrees with plain')


def request_profile(eval_step, batch, kernels, expected, label):
    """A full-width request: launches (which must be ``expected``), host ms
    (median of 3 after one untimed), device ms of K3, K13-K15 and of all
    kernels (``kernels_a_call``), busy share and peak memory."""
    eval_step(batch)
    before = {n: k.launches for n, k in kernels.items()}
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = eval_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launched = {n: (k.launches - before[n]) // 3 for n, k in kernels.items()}
    if launched != expected:
        raise AssertionError(f'{label} launched {launched}, expected '
                             f'{ {n: c for n, c in expected.items() if c} }')
    if not all(torch.isfinite(det[k]).all() for k in ('boxes_3d',
                                                      'scores_3d')):
        raise AssertionError(f'{label}: non-finite detections')
    wall = float(np.median(walls))
    found = kernels_a_call(lambda: eval_step(batch), FCAF3D_MARKERS, runs=3)
    ours = ', '.join(f'{k} {ms:.3f} ms in {n} launches'
                     for k, (ms, n) in found.items() if k != 'all' and n)
    print(f'{label}: {wall:.3f} ms (host clock, median of ' +
          ' / '.join(f'{w:.3f}' for w in walls) + f'), device kernels '
          f'{found["all"][0]:.3f} ms in {found["all"][1]} launches, busy '
          f'share {found["all"][0] / wall:.1%}, peak memory {peak:.1f} MiB, '
          f'{int(det["valid"].sum())} kept; {ours}; launches a request '
          f'{ {n: c for n, c in launched.items() if c} }', flush=True)
    return launched


def run_fcaf3d_path(dev, kernels):
    """FCAF3D (``configs/fcaf3d/fcaf3d_sunrgbd.py``, full width, seeded
    random weights, its norms calibrated) served: the kernel path against
    the plain path on a request of 2 scenes of 100,000 points (32,768
    voxels a scene), K13-K15 checked and timed on that request's own calls,
    the request and an eval batch of 8 timed with their launches, then a
    request under the bf16 policy (K14's bf16 entry) against float32."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    from demf_tpu_torch.tools.sparse_cases import calibrate_batch_norms
    t0 = time.perf_counter()
    model = zoo.build_detector(FCAF3D_CFG, device=dev, seed=0)
    request = batch_to_device(zoo.synth_fcaf3d_batch(
        2, p=FCAF3D_POINTS, seed=0), dev)
    calibrate_batch_norms(model, request)
    print(f'model: FCAF3D full width, '
          f'{sum(p.numel() for p in model.parameters())} parameters, built '
          f'in {time.perf_counter() - t0:.2f} s', flush=True)
    compare_sparse_paths(model, request, 'FCAF3D request (2 x 100000)')
    eval_step = make_eval_step(model)
    for k in kernels.values():
        k.launches = 0
    with recorded_calls() as calls:
        eval_step(request)
        torch.cuda.synchronize()
    serving = {n: k.launches for n, k in kernels.items()}
    if serving != LAUNCHES_PER_FCAF3D_REQUEST:
        raise AssertionError(f'FCAF3D request launched {serving}')
    # the request's tensors were made in inference mode
    with torch.inference_mode():
        measured = {
            'kernel_map': check_kernel_map(calls['kernel_map']),
            'sparse_conv': check_sparse_conv(calls['sparse_conv'],
                                             torch.float32),
            'sparse_conv_bf16': check_sparse_conv(calls['sparse_conv'],
                                                  torch.bfloat16),
            'sparse_conv_plan': check_conv_plans(calls['sparse_conv']),
            'nms3d_rotated': check_nms3d_rotated(calls['nms3d_rotated'])}
        time_sparse_levels(dev)
    del calls
    request_profile(eval_step, request, kernels,
                    LAUNCHES_PER_FCAF3D_REQUEST, 'FCAF3D request of 2')
    batch = batch_to_device(zoo.synth_fcaf3d_batch(
        FCAF3D_EVAL_SCENES, p=FCAF3D_POINTS, seed=1), dev)
    request_profile(eval_step, batch, kernels, LAUNCHES_PER_FCAF3D_REQUEST,
                    f'FCAF3D eval batch of {FCAF3D_EVAL_SCENES}')
    bf16_step = make_eval_step(model, torch.bfloat16)
    for k in kernels.values():
        k.launches = 0
    bf16_step(request)
    serving_bf16 = {n: k.launches for n, k in kernels.items()}
    request_profile(bf16_step, request, kernels,
                    LAUNCHES_PER_FCAF3D_REQUEST_BF16, 'FCAF3D bf16 request')
    check_fcaf3d_bf16(model, request, batch)
    del model, eval_step, bf16_step, batch
    torch.cuda.empty_cache()
    return measured, {'fcaf3d_serving': serving,
                      'fcaf3d_serving_bf16': serving_bf16}


def check_fcaf3d_bf16(model, request, batch):
    """The bf16 policy's per-voxel predictions against float32's: on the
    request and on the eval batch under ``FCAF3D_BF16_BOUND``; the request
    also through the plain path (printed beside them), and through the
    control (K14 fed rows and weights rounded to float8 e4m3), which must
    exceed the bound."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.utils import precision as prec
    k14 = sparse.sparse_conv_cuda

    def e4m3(x):
        return x.float().clamp(-448, 448).to(torch.float8_e4m3fn).to(x.dtype)

    def coarse_k14(feats, nbr, w, *plan):
        return k14(e4m3(feats), nbr, e4m3(w), *plan)

    def gap(scenes, strict=True, keys=('centerness', 'bbox_pred',
                                       'cls_scores')):
        with torch.inference_mode():
            return level_errors(prec.policy_call(model, torch.bfloat16,
                                                 scenes), model(scenes),
                                keys, strict)

    gaps = {'request': gap(request),
            f'eval batch of {FCAF3D_EVAL_SCENES}': gap(batch)}
    by_key = {key: gap(request, keys=(key,))
              for key in ('centerness', 'bbox_pred', 'cls_scores')}
    with plain_sparse_ops():
        plain = gap(request)
    with patched((sparse, 'sparse_conv_cuda', coarse_k14)):
        control = gap(request, strict=False)
    print(f'FCAF3D bf16: predictions within ' +
          ', '.join(f'{v:.4e} ({k})' for k, v in gaps.items()) +
          f' of float32 (relative to each tensor\'s largest; the request by '
          f'key ' + ', '.join(f'{k} {v:.4e}' for k, v in by_key.items()) +
          f'); the request through the plain path {plain:.4e}; the control '
          f'(K14 on e4m3-rounded rows and weights) {control:.4e}; bound '
          f'{FCAF3D_BF16_BOUND}', flush=True)
    if not max(gaps.values()) < FCAF3D_BF16_BOUND:
        raise AssertionError('the bf16 FCAF3D predictions stray from float32')
    if not control >= FCAF3D_BF16_BOUND:
        raise AssertionError('the bf16 bound does not catch the e4m3 control')


def run_demf_fcaf3d_path(dev, kernels):
    """DeMF-FCAF3D (``configs/demf/demf_fcaf3d.py``, full width, seeded
    random weights, its norms calibrated) served: the kernel path against
    the plain path, then a request of 2 scenes of 100,000 points with the
    image branch at 800x1344 uncached, and the same scenes with the
    branch's output carried as ``img_features`` (the cached path), which
    must agree with the uncached request."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    from demf_tpu_torch.tools.sparse_cases import calibrate_batch_norms
    t0 = time.perf_counter()
    model = zoo.build_detector(DEMF_FCAF3D_CFG, device=dev, seed=0)
    request = batch_to_device(zoo.synth_demf_fcaf3d_batch(
        2, p=FCAF3D_POINTS, hw=(800, 1344), valid_hw=(784, 1312), seed=0),
        dev)
    calibrate_batch_norms(model, request)
    print(f'model: DeMF-FCAF3D full width, '
          f'{sum(p.numel() for p in model.parameters())} parameters, built '
          f'in {time.perf_counter() - t0:.2f} s', flush=True)
    compare_sparse_paths(model, request, 'DeMF-FCAF3D request (2 x 100000, '
                                         '800x1344)')
    eval_step = make_eval_step(model)
    for k in kernels.values():
        k.launches = 0
    eval_step(request)
    serving = {n: k.launches for n, k in kernels.items()}
    if serving != LAUNCHES_PER_DEMF_FCAF3D_REQUEST:
        raise AssertionError(f'DeMF-FCAF3D request launched {serving}')
    request_profile(eval_step, request, kernels,
                    LAUNCHES_PER_DEMF_FCAF3D_REQUEST,
                    'DeMF-FCAF3D request of 2 (image branch uncached)')
    with torch.inference_mode():
        levels = model.extract_img_feat(request['img'],
                                        request['img_meta']['img_shape'])
        cached = dict(request, img_features=levels)
        del cached['img']
        gap = level_errors(model(cached), model(request))
    print(f'DeMF-FCAF3D cached path: predictions within {gap:.3e} of the '
          f'uncached request')
    if not gap < 2e-3:
        raise AssertionError('the cached DeMF-FCAF3D path strays')
    for k in kernels.values():
        k.launches = 0
    eval_step(cached)
    cached_launches = {n: k.launches for n, k in kernels.items()}
    request_profile(eval_step, cached, kernels,
                    LAUNCHES_PER_DEMF_FCAF3D_CACHED,
                    'DeMF-FCAF3D request of 2 (img_features cached)')
    del model, eval_step, levels, cached
    torch.cuda.empty_cache()
    return {'demf_fcaf3d_serving': serving,
            'demf_fcaf3d_serving_cached': cached_launches}


# -- the FCAF3D family trained: K14 on reverse tables, K16 ------------------

FCAF3D_TRAIN_SCENES = 8
FCAF3D_TRAIN_STEPS = 3
# the tiny configs (MinkResNet18: 31 convolutions, 30 reading features that
# take a gradient) through the train entry, 2 steps each; DeMF-FCAF3D's
# cache fill runs its 1-layer encoder once
FCAF3D_TINY_CFGS = (os.path.join('configs', 'synthetic', 'fcaf3d_tiny.py'),
                    os.path.join('configs', 'synthetic',
                                 'demf_fcaf3d_tiny.py'))
TINY_TRAIN_STEP = dict(kernel_map=11, sparse_conv=31, sparse_conv_backward=30,
                       sparse_conv_plan=28, sparse_conv_dweights=31,
                       sparse_max_pool=1, sparse_max_pool_backward=1)
LAUNCHES_TINY_TRAIN_ENTRY = (
    launch_counts(**{k: 2 * v for k, v in TINY_TRAIN_STEP.items()}),
    launch_counts(msda=3, msda_backward=2,
                  **{k: 2 * v for k, v in TINY_TRAIN_STEP.items()}))
# the first step on the kernel path against the same step on the plain path
# (the same weights, batch and dropout draws): losses within 1e-4 relative,
# the bound the CPU tests hold the port to against the JAX package (the two
# paths sum in other orders: K14's 3xTF32 tiles, K16's slices, K4's lists).
# The gradients are held to the plain path run in float64: each tensor's
# kernel-path error, of the tensor's largest, within max(TRAIN_GRAD_BOUND,
# TRAIN_GRAD_NOISE x the float32 plain path's).  Where float32 resolves a
# gradient the first term binds, the CPU tests' bound.  Where it cannot (the
# exact gradient cancels: the convs and norms of a level whose every
# consumer is a train-mode BatchNorm, layers 3-4 at random weights, where
# the float32 plain path strays up to 19% of a tensor's largest from
# float64) the same amplification takes the kernel path's own rounding,
# larger than float32 FMAs' (3xTF32, K14's ~1e-6 against its plain version
# in ``check_sparse_conv``), and the ratio of the two errors is a draw:
# ``demf_tpu_torch/tools/train_grad_noise.py`` read it at 0.0001-72.8 over
# 4 seeds of each model on an H100 (PERF.md), and TRAIN_GRAD_NOISE
# lies above the largest.  A bound that reaches 0.1 of its tensor's largest
# checks little: the line says how many; K14 on reverse tables and K16 are
# held on the step's own calls at 1e-5 besides (``check_sparse_conv``,
# ``check_sparse_dweights``).  The whole gradient is held to its norm the
# same way.
TRAIN_LOSS_BOUND = 1e-4
TRAIN_GRAD_BOUND = 1e-3
TRAIN_GRAD_NOISE = 100.0
TRAIN_MARKERS = {'K13': ('kernel_map_kernel',),
                 'K14': ('sparse_conv_tiles', 'sparse_conv_sum_parts',
                         'sparse_conv_plan'),
                 'K16': ('dweights_tiles', 'dweights_sum'),
                 'K17': ('pool_forward_kernel', 'pool_backward_kernel'),
                 'K3-K4': ('msda_',)}


def check_sparse_dweights(calls, dtype=torch.float32):
    """K16 on a train step's own calls (each convolution's features, table,
    row plan and output gradient; in bf16 the bf16 step's own) against
    ``sparse_conv_dweights_plain``: within 1e-5 of each result's largest
    (a bf16 product is exact in float32: both entries alike), the same bits
    on two calls; timed over all of them beside the plain version and one
    ``torch.matmul`` a tap over the gathered rows (the yardstick, in the
    calls' dtype).  Its bound: 2 x the (row, tap) pairs that exist x C x
    C_out operations at the peak of the operands' type (float32's 67
    TFLOP/s outside the tensor cores, bf16's 989 on them), or the bytes
    (features, table and output gradient read once, the float32 weight
    gradient written once), whichever is larger.  The float32 entry also
    prints its bound at the rate it runs, 3xTF32 (TF32's 495 over 3)."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import (PEAK_BF16_FLOPS, PEAK_FLOPS,
                                      PEAK_TF32_FLOPS, bound_ms, time_ms)
    from demf_tpu_torch.tools.sparse_cases import gather_dweights
    worst = flops = nbytes = 0.0
    yardsticks = []
    for feats, nbr, g, plan in calls:
        if feats.dtype != dtype or g.dtype != dtype:
            raise AssertionError(f'K16 {dtype}: a call of {feats.dtype}')
        got = sparse.sparse_conv_dweights_cuda(feats, nbr, g, plan)
        if not torch.equal(got, sparse.sparse_conv_dweights_cuda(
                feats, nbr, g, plan)):
            raise AssertionError(f'K16 {tuple(nbr.shape)}: other bits on a '
                                 f'second call')
        want = sparse.sparse_conv_dweights_plain(feats, nbr, g)
        top = max(want.abs().max().item(), 1e-30)
        err = (got - want).abs().max().item() / top
        if not err <= 1e-5:
            raise AssertionError(f'K16 {dtype} {tuple(feats.shape)} x '
                                 f'{tuple(nbr.shape)} -> {tuple(got.shape)}: '
                                 f'{err} of the largest')
        worst = max(worst, err)
        flops += 2.0 * int((nbr >= 0).sum()) * feats.shape[2] * g.shape[2]
        nbytes += (feats.element_size() * (feats.numel() + g.numel()) +
                   4 * (nbr.numel() + got.numel()))
        yardsticks.append(gather_dweights(feats, nbr, g))

    def kernel():
        for feats, nbr, g, plan in calls:
            sparse.sparse_conv_dweights_cuda(feats, nbr, g, plan)

    def plain():
        for feats, nbr, g, _ in calls:
            sparse.sparse_conv_dweights_plain(feats, nbr, g)

    def library():
        for fn in yardsticks:
            fn()

    ms, plain_ms, lib_ms = (time_ms(kernel, 5), time_ms(plain, 2),
                            time_ms(library, 5))
    least, by = bound_ms(flops, nbytes, PEAK_FLOPS if dtype == torch.float32
                         else PEAK_BF16_FLOPS)
    name = 'sparse_conv_dweights' + ('' if dtype == torch.float32 else
                                     '_bf16')
    if dtype == torch.float32:
        tf32, tf32_by = bound_ms(flops, nbytes, PEAK_TF32_FLOPS / 3)
        print(f'K16 {name} beside its 3xTF32 bound: kernel {ms:.4f} ms, '
              f'bound at TF32\'s {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s over 3 '
              f'{tf32:.6f} ms ({tf32_by}): {tf32 / ms:.1%} of it (the pinned '
              f'bound {least:.6f} ms: {least / ms:.1%})', flush=True)
    print(f'K16 {name}: {len(calls)} weight gradients of a train step, '
          f'{flops / 1e9:.3f} GFLOP of existing taps, max rel err '
          f'{worst:.3e}, the same bits twice; kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms, gather + matmul a tap {lib_ms:.4f} ms, bound '
          f'{least:.6f} ms ({by}; {flops / 1e9 / max(ms, 1e-9):.1f} TFLOP/s)',
          flush=True)
    return kernel_row(worst, ms, plain_ms, least, by, lib_ms)


def planted(feats):
    """The rows with NaN, inf and -inf planted in some channels and signed
    zeros in others (an output with a NaN or +-inf tap is 0, ties of +0
    and -0 are ties)."""
    x = feats.clone()
    x[:, 10::97, 0] = float('nan')
    x[:, 11::89, 1] = float('inf')
    x[:, 12::83, 2] = float('-inf')
    x[:, 13::7, 3] = -0.0
    x[:, 14::7, 3] = 0.0
    return x


def check_sparse_max_pool(calls, backward_calls, dtype):
    """K17 on a train step's own calls (the stem pool's rows, table and
    out_valid; in the backward its output gradient, reverse index, table
    and tie mask; in bf16 the bf16 step's), forward and backward: the
    output and the tie mask equal to ``sparse_max_pool_mask_plain`` and the
    chain on the card, the reverse index to ``sparse_max_pool_reader_plain``
    where that names a reader, d_in to ``sparse_max_pool_backward_plain``
    and to the chain's autograd, bit for bit, also with stale entries
    planted where the forward writes none; then the same on the rows with
    NaN, inf, -inf and signed zeros planted.  Each direction timed through
    its wrapper and on the device beside the chain (forward; its autograd
    backward), a gather to (B, M_out, K, C) and ``torch.amax`` (its
    autograd backward: a yardstick of time, whose ties split evenly) and
    its bound, the function's bytes of ``pool_bytes`` (the tie mask's and
    the reverse index's printed apart).  Returns the (forward, backward)
    rows."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import (bound_ms, device_kernels, same_bits,
                                      time_ms)
    from demf_tpu_torch.tools.sparse_cases import gather_amax, pool_bytes
    if len(calls) != 1 or len(backward_calls) != 1:
        raise AssertionError(f'K17: {len(calls)} forward and '
                             f'{len(backward_calls)} backward calls a step')
    feats, nbr, ov, _ = calls[0]
    grad, step_reader, _, step_mask = backward_calls[0]
    feats = feats.detach()
    m_in = feats.shape[1]
    if feats.dtype != dtype or grad.dtype != dtype:
        raise AssertionError(f'K17 {dtype}: a call of {feats.dtype}')
    worst = {}
    want_reader = sparse.sparse_max_pool_reader_plain(nbr, ov, m_in)
    read = want_reader >= 0
    # what stale memory may hold where the forward writes no entry: any int
    # around the table's range, and the taps of invalid rows that read
    stale = torch.randint(-9, nbr.shape[1] * 8 + 9, read.shape,
                          device=read.device, dtype=torch.int32)
    s, o, t = torch.nonzero((nbr >= 0) & ~ov[..., None], as_tuple=True)
    stale[s, nbr[s, o, t].long()] = (o * 8 + t).int()
    for label, x in (('the step\'s rows', feats), ('planted', planted(feats))):
        out, mask, reader = sparse.sparse_max_pool_cuda(x, nbr, ov)
        want, want_mask = sparse.sparse_max_pool_mask_plain(x, nbr, ov)
        xa = x.clone().requires_grad_()
        chain = sparse.sparse_max_pool_plain(xa, nbr, ov)
        d = sparse.sparse_max_pool_backward_cuda(grad, reader, nbr, mask)
        d_stale = sparse.sparse_max_pool_backward_cuda(
            grad, torch.where(read, reader, stale), nbr, mask)
        dx, = torch.autograd.grad(chain, xa, grad)
        ok = (same_bits(out, want) and torch.equal(mask, want_mask) and
              torch.equal(reader[read], want_reader[read]) and
              same_bits(out, chain.detach()) and same_bits(d, dx) and
              same_bits(d_stale, d) and
              same_bits(d, sparse.sparse_max_pool_backward_plain(
                  grad, nbr, mask, m_in)))
        if x is feats:
            ok = ok and torch.equal(mask, step_mask) and torch.equal(
                step_reader[read], want_reader[read])
        bits = mask.int()
        tied = int(((bits & (bits - 1)) > 0).sum())
        worst[label] = max((out.float() - chain.detach().float()).abs().max()
                           .item(), (d.float() - dx.float()).abs().max()
                           .item())
        print(f'K17 {str(dtype)[6:]} on {label}: {tuple(x.shape)} -> '
              f'{tuple(out.shape)} over {int((nbr >= 0).sum())} taps, '
              f'{tied} (row, channel) ties, {int((out == 0).sum())} zero '
              f'outputs, {int((~read).sum())} input rows unread; output, tie '
              f'mask, reverse index and d_in (also over stale index entries) '
              f'the plain versions\' bits and the chain\'s: {ok}',
              flush=True)
        if not ok:
            raise AssertionError(f'K17 {dtype} differs from the chain on '
                                 f'{label}')
    xa = feats.clone().requires_grad_()
    chain = sparse.sparse_max_pool_plain(xa, nbr, ov)
    _, mask, reader = sparse.sparse_max_pool_cuda(feats, nbr, ov)

    def forward():
        return sparse.sparse_max_pool_cuda(feats, nbr, ov)

    def backward():
        return sparse.sparse_max_pool_backward_cuda(grad, reader, nbr, mask)

    ms, b_ms = time_ms(forward, 20), time_ms(backward, 20)
    dev_ms, b_dev_ms = (sum(t for _, t in device_kernels(fn).values())
                        for fn in (forward, backward))
    plain_ms = time_ms(lambda: sparse.sparse_max_pool_plain(feats, nbr, ov),
                       5)
    lib_ms = time_ms(gather_amax(feats, nbr), 10)
    b_plain_ms = time_ms(lambda: torch.autograd.grad(
        chain, xa, grad, retain_graph=True), 5)
    b_lib_ms = time_ms(gather_amax(feats, nbr, grad), 10)
    taps = float((nbr >= 0).sum()) * feats.shape[2]
    need, design_bytes = pool_bytes(feats, nbr, ov)
    b_need, _ = pool_bytes(feats, nbr, ov, backward=True)
    least, by = bound_ms(taps, need)
    b_least, b_by = bound_ms(taps, b_need)
    design_ms = bound_ms(0.0, design_bytes)[0]
    print(f'K17 {str(dtype)[6:]}: forward {ms:.4f} ms through its wrapper, '
          f'{dev_ms:.4f} on the device (the chain '
          f'{plain_ms:.4f}, gather + amax {lib_ms:.4f}, bound {least:.6f} '
          f'ms by {by}, {need} bytes: {least / dev_ms:.1%} on the device); '
          f'backward {b_ms:.4f} ms, {b_dev_ms:.4f} on the device (the '
          f'chain\'s autograd {b_plain_ms:.4f}, gather + amax\'s autograd '
          f'{b_lib_ms:.4f}, bound {b_least:.6f} ms by {b_by}, {b_need} '
          f'bytes: {b_least / b_dev_ms:.1%} on the device); the tie mask and '
          f'the reverse index, {design_bytes} bytes each way, {design_ms:.6f}'
          f' ms more', flush=True)
    return (kernel_row(worst['the step\'s rows'], ms, plain_ms, least, by,
                       lib_ms),
            kernel_row(worst['the step\'s rows'], b_ms, b_plain_ms, b_least,
                       b_by, b_lib_ms))


def fcaf3d_train_batch(maker, **kw):
    """``maker``'s scenes (numpy) with the GT boxes twice the size and 1.5 m
    further down the x axis.  The voxel capacity keeps each scene's lowest
    keys, a slab at low x that the synthetic boxes seldom reach: without
    positives a step leaves the centerness and box losses at 0 and their
    backward unexercised."""
    batch = maker(**kw)
    batch['gt_bboxes_3d'][..., 3:6] *= 2
    batch['gt_bboxes_3d'][..., 0] -= 1.5
    return batch


def train_pass(model, batch, seed=0):
    """One forward, loss and backward in train mode, no update: (losses,
    {parameter name: gradient})."""
    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(batch['points'].device).manual_seed(seed)
    losses = model.loss(model(batch, generator=gen), batch)
    sum(losses.values()).backward()
    return ({k: v.detach() for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None})


def in_float64(obj):
    """A batch (dicts, tuples, tensors) with its floating tensors in
    float64."""
    if isinstance(obj, dict):
        return {k: in_float64(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(in_float64(v) for v in obj)
    if torch.is_tensor(obj) and obj.is_floating_point():
        return obj.double()
    return obj


def train_grad_errors(model, batch, label):
    """The first train step's losses and gradients on the kernel path (its
    K13, K14 and K16 calls recorded), on the plain path from the same state,
    and on the plain path in float64; the model's state is put back.
    Returns (kernel losses, plain losses, {parameter: (kernel error, float32
    plain error)} of the tensor's largest float64 gradient, the whole
    gradient's (kernel, plain) error of its norm, whether every loss and
    gradient is finite, the calls)."""
    state = copy.deepcopy(model.state_dict())
    with recorded_calls() as calls:
        got_l, got_g = train_pass(model, batch)
        torch.cuda.synchronize()
    model.load_state_dict(state)
    with plain_sparse_ops():
        want_l, want_g = train_pass(model, batch)
        model.load_state_dict(state)
        model64 = copy.deepcopy(model).double()
        _, ref_g = train_pass(model64, in_float64(batch))
    del model64
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    if set(got_g) != set(want_g) or set(got_l) != set(want_l):
        raise AssertionError(f'{label}: the two paths train other tensors')
    finite = all(torch.isfinite(v).all() for v in list(got_l.values()) +
                 list(got_g.values()))
    errors = {}
    diff = plain_diff = norm = 0.0
    for name, ref in ref_g.items():
        top = max(ref.abs().max().item(), 1e-300)
        got, plain = got_g[name].double(), want_g[name].double()
        errors[name] = ((got - ref).abs().max().item() / top,
                        (plain - ref).abs().max().item() / top)
        diff += (got - ref).square().sum().item()
        plain_diff += (plain - ref).square().sum().item()
        norm += ref.square().sum().item()
    whole = ((diff / max(norm, 1e-300)) ** 0.5,
             (plain_diff / max(norm, 1e-300)) ** 0.5)
    return got_l, want_l, errors, whole, finite, calls


def grad_bound(plain):
    """A gradient's bound, of its tensor's largest, where the float32 plain
    path strays ``plain`` from float64."""
    return max(TRAIN_GRAD_BOUND, TRAIN_GRAD_NOISE * plain)


def compare_train_paths(model, batch, label):
    """``train_grad_errors`` held to ``TRAIN_LOSS_BOUND`` and ``grad_bound``
    (the comment above them says why).  Returns the calls."""
    got_l, want_l, errors, (whole, whole_plain), finite, calls = \
        train_grad_errors(model, batch, label)
    loss_err = max((got_l[k] - w).abs().item() / max(w.abs().item(), 1e-30)
                   for k, w in want_l.items())
    rows = sorted((k / grad_bound(p), k, p, n) for n, (k, p) in
                  errors.items())
    over = [r for r in rows if r[0] > 1]
    by_factor = sum(TRAIN_GRAD_NOISE * p > TRAIN_GRAD_BOUND
                    for _, _, p, _ in rows)
    loose = sum(grad_bound(p) >= 0.1 for _, _, p, _ in rows)
    print(f'{label}: kernel path vs plain path on the first step, losses ' +
          ', '.join(f'{k} {float(v):.5f}' for k, v in got_l.items()) +
          f'; max rel err {loss_err:.3e} (bound {TRAIN_LOSS_BOUND}); '
          f'{len(rows)} gradients against the plain path in float64, each '
          f'within max({TRAIN_GRAD_BOUND:g}, {TRAIN_GRAD_NOISE:g} x the '
          f'float32 plain error) of its largest ({by_factor} bounds set by '
          f'the factor, {loose} of them 0.1 or more), the closest (kernel / '
          f'plain error) ' +
          ', '.join(f'{n} {k:.2e} / {p:.2e}' for _, k, p, n in rows[-3:]) +
          f'; the whole gradient {whole:.3e} / {whole_plain:.3e} of its '
          f'norm; K14 {len(calls["sparse_conv"])} forward, '
          f'{len(calls["sparse_conv_backward"])} on reverse tables, K16 '
          f'{len(calls["sparse_conv_dweights"])}', flush=True)
    if not finite or not loss_err <= TRAIN_LOSS_BOUND or over or not \
            whole <= grad_bound(whole_plain):
        raise AssertionError(f'{label}: the kernel path strays from plain: '
                             f'{over[-5:]}')
    return calls


def device_ms_by_op(fn, rows=14):
    """One call of ``fn`` under torch.profiler: the device ms of its
    kernels by the op whose host range launched them (each op's self
    device time: an aten op, an autograd node's evaluation, or the
    trainer's phase for the port's own kernels, which launch through
    ctypes outside any aten op), the largest ``rows``: [(op, device ms,
    calls)], and the device ms under no op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from demf_tpu_torch.engine.trainer import PHASES
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    # the phases' ranges also show on the device's timeline: not kernels
    busy = sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA and
               e.key not in PHASES) / 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in averages if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    return ops[:rows], busy - sum(ms for _, ms, _ in ops)


def run_train_steps(step, batch, kernels, expected, label, record=False):
    """``FCAF3D_TRAIN_STEPS`` train steps with every count at 0 before each:
    each must launch ``expected`` and give finite losses; then each step's
    host ms, one profiled step's device ms by kernel and busy share, the
    rest of its device time by op, and the peak memory.  With ``record``
    the first step's K13, K14, K16 and K15 calls are kept
    (``recorded_calls``).  Returns (a step's launches, the first step's
    metrics as floats, the calls or None)."""
    gen = torch.Generator(batch['points'].device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    first = calls = None
    for i in range(FCAF3D_TRAIN_STEPS):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        with recorded_calls() if record and i == 0 else \
                contextlib.nullcontext() as kept:
            t0 = time.perf_counter()
            metrics = step(batch, gen)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first, calls = {k: float(v) for k, v in metrics.items()}, kept
        launched = {n: k.launches for n, k in kernels.items()}
        if launched != expected:
            raise AssertionError(
                f'{label} step {i} launched '
                f'{ {n: c for n, c in launched.items() if c} }, expected '
                f'{ {n: c for n, c in expected.items() if c} }')
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'{label} step {i}: non-finite {metrics}')
        print(f'{label} step {i}: {walls[-1]:.3f} ms (host clock), ' +
              ', '.join(f'{k} {float(v):.4f}'
                        for k, v in sorted(metrics.items())), flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    found = kernels_a_call(lambda: step(batch, gen), TRAIN_MARKERS, runs=2)
    wall = float(np.median(walls[1:]))
    ours = ', '.join(f'{k} {ms:.3f} ms in {n} launches'
                     for k, (ms, n) in found.items() if k != 'all' and n)
    print(f'{label}: a step {wall:.3f} ms (host clock, median of steps 2-'
          f'{FCAF3D_TRAIN_STEPS}), device kernels {found["all"][0]:.3f} ms '
          f'in {found["all"][1]} launches, busy share '
          f'{found["all"][0] / wall:.1%}, peak memory {peak:.1f} MiB; {ours}; '
          f'launches a step { {n: c for n, c in launched.items() if c} }',
          flush=True)
    ops, loose = device_ms_by_op(lambda: step(batch, gen))
    print(f'{label}: a profiled step\'s device ms by the op that launched '
          f'them (self time; the port\'s kernels under the phase or autograd '
          f'node that called them): ' +
          '; '.join(f'{op} {ms:.3f} ({n}x)' for op, ms, n in ops) +
          f'; under no op {loose:.3f}', flush=True)
    return launched, first, calls


def losses_against(first, fp32_first, label):
    """A bf16 step's losses within 0.2 of the float32 step's on the same
    weights and batch (``run_training_bf16``'s bound, the JAX package's)."""
    rel = {k: abs(first[k] - v) / max(abs(v), 1e-6)
           for k, v in fp32_first.items() if k != 'grad_norm'}
    worst = max(rel, key=rel.get)
    print(f'{label} step 0 vs the float32 step 0: losses max rel err '
          f'{rel[worst]:.3e} ({worst}; bound 0.2); grad_norm '
          f'{first["grad_norm"]:.3f} against {fp32_first["grad_norm"]:.3f}',
          flush=True)
    if not rel[worst] < 0.2:
        raise AssertionError(f'{label} strays from float32')


def masters_in_float32(model, optimizer, label):
    """The master weights, the AdamW state and the BatchNorm statistics of
    a bf16 trainer stay float32."""
    states = [v for st in optimizer.state.values() for v in st.values()
              if torch.is_tensor(v) and v.is_floating_point()]
    buffers = [b for n, b in model.named_buffers() if 'running' in n]
    if not states or not buffers or any(
            t.dtype != torch.float32
            for t in list(model.parameters()) + states + buffers):
        raise AssertionError(f'{label}: masters, optimizer state or BN '
                             f'statistics left float32')
    print(f'{label}: {len(buffers)} BN statistics, {len(states)} optimizer '
          f'tensors and every master weight float32', flush=True)


def fcaf3d_trainer(dev, seed=0, bf16=False):
    """FCAF3D's full-width trainer (``configs/fcaf3d/fcaf3d_sunrgbd.py``
    through ``zoo.build_trainer``: AdamW, grad clip 10, the step schedule;
    under the bf16 policy with ``bf16``) and 8 scenes of 100,000 points,
    weights and scenes made from ``seed``: (model, optimizer, step,
    batch)."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device
    cfg = copy.deepcopy(zoo.load_model_cfg(FCAF3D_CFG))
    cfg.bf16 = bf16
    model, optimizer, step = zoo.build_trainer(cfg, device=dev, seed=seed)
    if step.compute_dtype != (torch.bfloat16 if bf16 else None):
        raise AssertionError(f'bf16={bf16} did not select its policy')
    batch = batch_to_device(fcaf3d_train_batch(
        zoo.synth_fcaf3d_batch, b=FCAF3D_TRAIN_SCENES, p=FCAF3D_POINTS,
        seed=seed), dev)
    return model, optimizer, step, batch


def demf_fcaf3d_trainer(dev, seed=0, bf16=False):
    """DeMF-FCAF3D's full-width trainer (``configs/demf/demf_fcaf3d.py``:
    decoder lr_mult 0.05, the frozen image branch; under the bf16 policy
    with ``bf16``) and 8 scenes of 100,000 points with 800x1344 images,
    whose features the frozen branch makes once (the cache), all made from
    ``seed``: (model, optimizer, step, batch)."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, compute_image_features
    cfg = copy.deepcopy(zoo.load_model_cfg(DEMF_FCAF3D_CFG))
    cfg.bf16 = bf16
    model, optimizer, step = zoo.build_trainer(cfg, device=dev, seed=seed)
    if step.compute_dtype != (torch.bfloat16 if bf16 else None):
        raise AssertionError(f'bf16={bf16} did not select its policy')
    batch = batch_to_device(fcaf3d_train_batch(
        zoo.synth_demf_fcaf3d_batch, b=FCAF3D_TRAIN_SCENES, p=FCAF3D_POINTS,
        hw=(800, 1344), valid_hw=(784, 1312), seed=seed), dev)
    batch['img_features'] = compute_image_features(model, batch)
    del batch['img']
    torch.cuda.synchronize()
    return model, optimizer, step, batch


def run_fcaf3d_train_path(dev, kernels):
    """FCAF3D trained at full width (``fcaf3d_trainer``): the first step
    against the plain path, K16, K14 on reverse tables and K17 (forward and
    backward) checked on that step's own calls, then 3 steps; then the same
    under the bf16 policy (``run_train_bf16``), whose first step's calls
    hold the bf16 entries.
    Returns (the kernel rows, the launches by path)."""
    t0 = time.perf_counter()
    model, _, step, batch = fcaf3d_trainer(dev)
    print(f'model: FCAF3D trainer, full width, built in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    calls = compare_train_paths(model, batch, f'FCAF3D train step '
                                              f'({FCAF3D_TRAIN_SCENES} x '
                                              f'{FCAF3D_POINTS})')
    measured = {
        'sparse_conv_dweights': check_sparse_dweights(
            calls['sparse_conv_dweights']),
        'sparse_conv_backward': check_sparse_conv(
            calls['sparse_conv_backward'], torch.float32,
            'a train step\'s backward (reverse tables)')}
    measured['sparse_max_pool'], measured['sparse_max_pool_backward'] = \
        check_sparse_max_pool(calls['sparse_max_pool'],
                              calls['sparse_max_pool_backward'],
                              torch.float32)
    del calls
    torch.cuda.empty_cache()
    launched, first, _ = run_train_steps(step, batch, kernels,
                                         LAUNCHES_PER_FCAF3D_STEP,
                                         'FCAF3D train')
    del model, step, batch
    torch.cuda.empty_cache()
    by_path = {'fcaf3d_train': launched}
    launched, calls = run_train_bf16(fcaf3d_trainer, dev, kernels, first,
                                     LAUNCHES_PER_FCAF3D_STEP_BF16,
                                     'FCAF3D train bf16')
    by_path['fcaf3d_train_bf16'] = launched
    measured['sparse_conv_dweights_bf16'] = check_sparse_dweights(
        calls['sparse_conv_dweights'], torch.bfloat16)
    measured['sparse_conv_backward_bf16'] = check_sparse_conv(
        calls['sparse_conv_backward'], torch.bfloat16,
        'a bf16 train step\'s backward (reverse tables)')
    (measured['sparse_max_pool_bf16'],
     measured['sparse_max_pool_backward_bf16']) = check_sparse_max_pool(
        calls['sparse_max_pool'], calls['sparse_max_pool_backward'],
        torch.bfloat16)
    del calls
    torch.cuda.empty_cache()
    return measured, by_path


def run_train_bf16(trainer, dev, kernels, fp32_first, expected, label):
    """``trainer``'s model under the bf16 policy from the weights, batch and
    draws of its float32 phase: 3 steps with ``expected`` launches each
    (the first step's calls kept), the first step's losses within 0.2 of
    the float32 first step's; the masters, optimizer state and BatchNorm
    statistics float32.  Returns (a step's launches, the first step's
    calls)."""
    t0 = time.perf_counter()
    model, optimizer, step, batch = trainer(dev, bf16=True)
    print(f'model: {label}, full width, built in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    launched, first, calls = run_train_steps(step, batch, kernels, expected,
                                             label, record=True)
    losses_against(first, fp32_first, label)
    masters_in_float32(model, optimizer, label)
    del model, optimizer, step, batch
    torch.cuda.empty_cache()
    return launched, calls


def run_demf_fcaf3d_train_path(dev, kernels):
    """DeMF-FCAF3D trained at full width (``demf_fcaf3d_trainer``): the
    first step against the plain path (MSDA plain there too), then 3 steps,
    then 3 under the bf16 policy; then the train entry on both tiny
    configs."""
    from demf_tpu_torch import train as train_entry
    t0 = time.perf_counter()
    model, _, step, batch = demf_fcaf3d_trainer(dev)
    print(f'model: DeMF-FCAF3D trainer, full width, built and its image '
          f'features cached in {time.perf_counter() - t0:.2f} s', flush=True)
    compare_train_paths(model, batch, f'DeMF-FCAF3D train step '
                                      f'({FCAF3D_TRAIN_SCENES} x '
                                      f'{FCAF3D_POINTS}, 800x1344 cached)')
    torch.cuda.empty_cache()
    launched, first, _ = run_train_steps(step, batch, kernels,
                                         LAUNCHES_PER_DEMF_FCAF3D_STEP,
                                         'DeMF-FCAF3D train')
    del model, step, batch
    torch.cuda.empty_cache()
    by_path = {'demf_fcaf3d_train': launched}
    by_path['demf_fcaf3d_train_bf16'], _ = run_train_bf16(
        demf_fcaf3d_trainer, dev, kernels, first,
        LAUNCHES_PER_DEMF_FCAF3D_STEP_BF16, 'DeMF-FCAF3D train bf16')
    for cfg, expected in zip(FCAF3D_TINY_CFGS, LAUNCHES_TINY_TRAIN_ENTRY):
        with tempfile.TemporaryDirectory() as wd:
            _, out, seconds, launches = run_entry(
                train_entry.main, [cfg, '--synthetic', '--steps', '2',
                                   '--points', '1024', '--work-dir', wd],
                kernels, expected)
            if not os.path.exists(os.path.join(wd, 'checkpoints',
                                               'epoch_1.pth')):
                raise AssertionError(f'{cfg}: no checkpoint')
        print(f'train entry {cfg} --synthetic --steps 2: {seconds:.2f} s, '
              f'launches { {n: c for n, c in launches.items() if c} }',
              flush=True)
        by_path[f'train_entry_{os.path.basename(cfg)[:-3]}'] = launches
    return by_path


# -- M4: launchers, two ranks, the fused eval and the flip aug-test ---------

# the launcher path: the train entry's synthetic steps under --launcher
# pytorch on one NCCL rank, in a process of its own
LAUNCHER_STEPS = 3
LAUNCHER_CHILD = 'import chip_smoke; chip_smoke.launcher_child()'
# the two-rank step: DeMF-VoteNet stage 2 at full width (every dropout 0),
# a global batch of 16 scenes split 8 + 8 over two ranks on the one card
# (gloo: NCCL takes one rank a card), against one process on all 16.  The
# two runs differ only in the order of float32 sums over scenes (the
# statistics' and normalizers' partial sums 8 + 8, the gradients' rows),
# and so does one process on the same scenes in reverse order: that run
# measures the float32 noise of regrouping them, carried through the
# network (votes that move by an ulp can change the aggregation's FPS
# picks).  Each quantity is bounded in the manner of ``grad_bound``: the
# loss within max(1e-5, TWO_RANK_NOISE x the reversed run's error), each
# gradient within max(1e-3, TWO_RANK_NOISE x the reversed run's error) of
# its tensor's largest (a largest under 1e-4 of the largest gradient of
# all, as for a bias just before a train-mode BatchNorm, whose true
# gradient is 0, counts as that floor), each running statistic within
# max(1e-4, TWO_RANK_NOISE x the reversed run's error) of its largest; the
# ranks' parameters the same bits
TWO_RANK_CASE = dict(config='demf/demf_votenet.py', batch=16, points=20000,
                     hw=(800, 1344), gt=64)
TWO_RANK_LOSS_BOUND = 1e-5
TWO_RANK_GRAD_BOUND = 1e-3
TWO_RANK_NOISE_FLOOR = 1e-4
TWO_RANK_STAT_BOUND = 1e-4
TWO_RANK_NOISE = 10.0
# the fused eval: folding BatchNorm into the convs moves the predictions by
# float32 rounding, and a rounding can turn a decision the model takes on
# its outputs (a point at a ball query's radius, a score at score_thr, an
# IoU at the NMS threshold, the order of two scores), which then moves a
# proposal or a chain of detections.  A checkpoint two steps from random
# weights has many of them near their thresholds: of nine such checkpoints
# on an H100, two had 8.1% and 12.1% of their detections moved, and 9.4% of
# the values of one output of the forward (the second ensemble layer's).
# So the check counts what agrees: each floating output of the forward on
# the first val batch, value by value, against the unfused model's (a share
# FUSED_AGREE_SHARE within FUSED_BOUND, taken as |a - b| <= FUSED_BOUND *
# (1 + |b|)), and the two evals' detections matched across them (the same
# scene and label, score and box within FUSED_BOUND; a share
# FUSED_MATCH_SHARE of each side's).  A pair folded wrongly moves nearly
# every value of each output downstream of it, and most detections.
FUSED_BOUND = 1e-4
FUSED_AGREE_SHARE = 0.5
FUSED_MATCH_SHARE = 0.5
# the flip aug-test: twice a request's launches and the merge's one K8
AUG_NMS_THR = 0.25
LAUNCHES_AUG_TEST = {n: 2 * c + (n == 'nms3d')
                     for n, c in LAUNCHES_PER_REQUEST.items()}
# host ms of the no-launcher train steps (run_training_path), beside which
# the launcher path prints its own
STEP_MS = []


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launcher_child():
    """Run in a process of its own by ``run_launcher_path``: the train
    entry under ``--launcher pytorch`` (the env names rank 0 of 1), each
    step's host ms and launches recorded around ``TrainStep.__call__``;
    prints them as a ``LAUNCHER_STEPS`` JSON line."""
    from demf_tpu_torch import ops, train
    from demf_tpu_torch.engine import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = ops.kernels()
    steps = []
    call = trainer.TrainStep.__call__

    def counted(self, batch, generator):
        torch.cuda.synchronize()
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        out = call(self, batch, generator)
        torch.cuda.synchronize()
        steps.append(dict(
            ms=(time.perf_counter() - t0) * 1e3,
            launches={n: k.launches - before[n] for n, k in kernels.items()},
            backend=torch.distributed.get_backend(),
            world=torch.distributed.get_world_size()))
        return out

    trainer.TrainStep.__call__ = counted
    train.main(['configs/demf/demf_votenet.py', '--launcher', 'pytorch',
                '--synthetic', '--steps', str(LAUNCHER_STEPS)])
    print('LAUNCHER_STEPS ' + json.dumps(steps), flush=True)


def run_launcher_path(kernels):
    """``python -m demf_tpu_torch.train configs/demf/demf_votenet.py
    --launcher pytorch --synthetic --steps 3`` in a subprocess with
    RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 and a free MASTER_PORT: NCCL on the
    card.  Each step must launch what the no-launcher step launches
    (``LAUNCHES_PER_STEP``); its host ms are printed beside the training
    path's.  Returns the launches of its steps."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
               MASTER_ADDR='127.0.0.1', MASTER_PORT=str(_free_port()))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, '-c', LAUNCHER_CHILD], cwd=root,
                       env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = [line for line in p.stdout.splitlines()
             if line.startswith('LAUNCHER_STEPS ')]
    if p.returncode or not lines:
        raise AssertionError(f'launcher path exited {p.returncode}:\n'
                             f'{p.stdout[-3000:]}\n{p.stderr[-3000:]}')
    steps = json.loads(lines[-1].split(' ', 1)[1])
    if len(steps) != LAUNCHER_STEPS:
        raise AssertionError(f'launcher path took {len(steps)} steps')
    for i, step in enumerate(steps):
        if step['launches'] != LAUNCHES_PER_STEP:
            raise AssertionError(f'launcher step {i} launched '
                                 f'{step["launches"]}, expected '
                                 f'{LAUNCHES_PER_STEP}')
        if (step['backend'], step['world']) != ('nccl', 1):
            raise AssertionError(f'launcher step {i} on {step["backend"]} '
                                 f'of {step["world"]} ranks')
    logged = [line.split(' - ', 1)[-1] for line in p.stdout.splitlines()
              if 'Epoch [' in line]
    print(f'launcher path: train entry under --launcher pytorch (NCCL, '
          f'rank 0 of 1) in a subprocess, {seconds:.3f} s in all; step ms '
          f'(host clock, synchronized) '
          f'{[round(s["ms"], 3) for s in steps]} beside the no-launcher '
          f'steps\' {[round(ms, 3) for ms in STEP_MS]} (16 x 20,000 '
          f'points, 800x1344); each launched {steps[0]["launches"]}; its '
          f'log: {logged[-1] if logged else "none"}', flush=True)
    return {n: sum(s['launches'][n] for s in steps) for n in KERNEL_NAMES}


def run_two_rank_step(kernels, device='cuda'):
    """Two ranks on the one card over gloo (``tools/dp_equivalence.py``,
    one subprocess a rank, ``TWO_RANK_CASE``) against one process on the
    whole batch: the first step's loss, every gradient after the
    all-reduce and every running statistic, within the bounds above; the
    ranks' parameters the same bits; each step's launches
    ``LAUNCHES_PER_STEP``; the step's host ms and its all-reduce's share.
    Returns rank 0's launches."""
    from demf_tpu_torch.tools import dp_equivalence as dpe
    torch.cuda.empty_cache()
    # the ranks' records (~0.3 GB each) pass through build/ of this checkout
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'build')
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    ranks = dpe.run_ranks([TWO_RANK_CASE], world=2, device=device,
                          backend='gloo', steps=2, threads=4, timeout=900,
                          work_dir=build_dir)
    seconds = time.perf_counter() - t0
    mine = [r[0]['float32'] for r in ranks]
    one = dpe.run_case(TWO_RANK_CASE, device, steps=2)
    rev = dpe.run_case(TWO_RANK_CASE, device, steps=1, reverse=True)
    for who, rec in [('one process', one)] + [
            (f'rank {r}', m) for r, m in enumerate(mine)]:
        if rec['launches'] != [LAUNCHES_PER_STEP] * 2:
            raise AssertionError(f'two-rank step: {who} launched '
                                 f'{rec["launches"]}')
    result = dpe.compare(one, mine)
    if result['same_bits']:
        raise AssertionError(f'two-rank step: the ranks differ in '
                             f'{result["same_bits"][:5]}')
    loss_noise = dpe.compare(one, [rev])['loss']
    top = max(g.abs().max().item() for g in one['grads'].values())

    def errors(got, want, floor=0.0):
        return {n: (got[n].double() - w.double()).abs().max().item() /
                max(w.abs().max().item(), floor, 1e-30)
                for n, w in want.items()}

    grads = errors(mine[0]['grads'], one['grads'], TWO_RANK_NOISE_FLOOR * top)
    noise = errors(rev['grads'], one['grads'], TWO_RANK_NOISE_FLOOR * top)
    stats = errors(mine[0]['stats'], one['stats'])
    stat_noise = errors(rev['stats'], one['stats'])
    worst = sorted((e / max(TWO_RANK_GRAD_BOUND, TWO_RANK_NOISE * noise[n]),
                    n) for n, e in grads.items())
    worst_stat = sorted((e / max(TWO_RANK_STAT_BOUND,
                                 TWO_RANK_NOISE * stat_noise[n]), n)
                        for n, e in stats.items())
    loss_bound = max(TWO_RANK_LOSS_BOUND, TWO_RANK_NOISE * loss_noise)
    print(f'two-rank step: against one process on the 16, first loss '
          f'{one["losses"][0]["loss"]:.5f} vs '
          f'{mine[0]["losses"][0]["loss"]:.5f} (rel {result["loss"]:.3e}; '
          f'the reversed order {loss_noise:.3e}; bound {loss_bound:.3e}); '
          f'{len(grads)} gradients, the nearest their bounds (rank / '
          f'reversed error of the largest, floor {TWO_RANK_NOISE_FLOOR} of '
          f'all): ' + ', '.join(f'{n} {grads[n]:.2e} / {noise[n]:.2e}'
                                for _, n in worst[-4:]) +
          f'; {len(stats)} running statistics, the nearest: ' +
          ', '.join(f'{n} {stats[n]:.2e} / {stat_noise[n]:.2e}'
                    for _, n in worst_stat[-2:]), flush=True)
    if not (result['loss'] <= loss_bound and worst[-1][0] <= 1 and
            worst_stat[-1][0] <= 1):
        raise AssertionError(f'two-rank step strays from one process past '
                             f'its bounds: {worst[-3:]}, {worst_stat[-2:]}')
    # the second step's times: the first one warms the card up
    step_ms = mine[0]['step_s'][1] * 1e3
    reduce_ms = mine[0]['all_reduce_s'][1] * 1e3
    print(f'two-rank step: DeMF-VoteNet stage 2, 16 scenes split 8 + 8 over '
          f'two ranks on one card over gloo, {seconds:.3f} s for both '
          f'processes in all; every gradient and statistic within its '
          f'bound; parameters the same bits on both ranks after 2 steps; '
          f'rank 0 second step {step_ms:.3f} ms (host clock), of which the '
          f'gloo all-reduce of gradients and metrics {reduce_ms:.3f} ms '
          f'({reduce_ms / step_ms:.1%}) and all its '
          f'{mine[0]["collectives"][1]} all-reduces (the statistics\' and '
          f'normalizers\' too, each from a synchronize to a synchronize) '
          f'{mine[0]["collective_s"][1] * 1e3:.3f} ms '
          f'({mine[0]["collective_s"][1] / mine[0]["step_s"][1]:.1%}); '
          f'rank 1 {mine[1]["step_s"][1] * 1e3:.3f} ms; the two ranks share '
          f'the card, so their kernels take turns; one process on all 16 '
          f'{one["step_s"][1] * 1e3:.3f} ms', flush=True)
    return {n: sum(step[n] for step in mine[0]['launches'])
            for n in KERNEL_NAMES}


def floating_leaves(tree, name='out'):
    """The floating tensors of a nested dict / list / tuple, in order, as
    (path, tensor)."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in floating_leaves(v, f'{name}.{k}')]
    if isinstance(tree, (list, tuple)):
        return [t for k, v in enumerate(tree)
                for t in floating_leaves(v, f'{name}[{k}]')]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return [(name, tree)]
    return []


def fused_forward_agreement(cfg, ckpt, val_set, batch):
    """The checkpoint's model and a copy folded by ``fuse_conv_bn`` on the
    eval entry's first val batch (its draws): -> (the least share, over the
    forward's floating outputs, of elements within ``FUSED_BOUND`` of the
    unfused ones, that output's path, the count of outputs and of
    elements, the largest and the median difference)."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.data.loader import collate_fixed
    from demf_tpu_torch.engine import batch_to_device, load_checkpoint
    from demf_tpu_torch.engine.fuse_bn import fuse_conv_bn
    model = zoo.build_detector(cfg.model, seed=0)
    load_checkpoint(ckpt, model)
    fused = copy.deepcopy(model)
    fuse_conv_bn(fused)
    np.random.seed(7)
    inputs = batch_to_device(collate_fixed(
        [val_set[i] for i in range(batch)], max_gt=cfg.get('max_gt', 64)),
        next(model.parameters()).device)
    with torch.inference_mode():
        want = floating_leaves(model(inputs))
        got = floating_leaves(fused(inputs))
    shares, errs = [], []
    for (name, w), (_, g) in zip(want, got):
        w, g = w.float().flatten(), g.float().flatten()
        err = ((g - w).abs() / (1 + w.abs())).nan_to_num(
            posinf=float('inf'))
        err = torch.where((g == w) | (g.isnan() & w.isnan()),
                          torch.zeros_like(err), err)
        shares.append(((err <= FUSED_BOUND).float().mean().item(), name))
        errs.append(err)
    errs = torch.cat(errs)
    least, name = min(shares)
    return (least, name, len(shares), errs.numel(), errs.max().item(),
            errs.median().item())


def matched_detections(a, b):
    """-> (how many of the results ``a``'s detections have a match in
    ``b``'s, how many of ``b``'s have one in ``a``'s): the same scene and
    label, the score and each box term within ``FUSED_BOUND``."""
    hits = [0, 0]
    for x, y in zip(a, b):
        for label in np.union1d(x['labels_3d'], y['labels_3d']):
            i = x['labels_3d'] == label
            j = y['labels_3d'] == label
            sx = np.concatenate([x['scores_3d'][i, None],
                                 x['boxes_3d'][i]], 1)
            sy = np.concatenate([y['scores_3d'][j, None],
                                 y['boxes_3d'][j]], 1)
            close = (np.abs(sx[:, None] - sy[None]) <=
                     FUSED_BOUND * (1 + np.abs(sy[None]))).all(-1)
            hits[0] += int(close.any(1).sum())
            hits[1] += int(close.any(0).sum())
    return hits


def check_fused_eval(eval_entry, cfg_file, ckpt, unfused, work_dir,
                     kernels):
    """The eval entry with ``--fuse-conv-bn --show-dir`` on the dataset
    path's checkpoint and the same draws as its unfused eval: its
    detections matched to the unfused ones (``FUSED_MATCH_SHARE``), the
    folded model's forward held to the unfused one on the first val batch
    (``FUSED_AGREE_SHARE``), and three ``.obj`` files a scene written.
    Returns its launches."""
    from demf_tpu_torch.data import build_dataset
    from demf_tpu_torch.utils.config import Config
    show = os.path.join(work_dir, 'show')
    out_file = os.path.join(work_dir, 'fused.pkl')
    np.random.seed(7)
    _, out, seconds, launches = run_entry(
        eval_entry.main, [cfg_file, ckpt, '--eval', 'mAP', '--fuse-conv-bn',
                          '--show-dir', show, '--out', out_file], kernels,
        LAUNCHES_EVAL_ENTRY)
    fused_line = [line for line in out.splitlines()
                  if line.startswith('fused ')]
    with open(out_file, 'rb') as f:
        fused = pickle.load(f)
    if not fused_line or len(fused) != len(unfused):
        raise AssertionError(f'fused eval: {fused_line}, {len(fused)} '
                             f'results')
    counts = [sum(len(r['scores_3d']) for r in rs) for rs in (fused, unfused)]
    hits = matched_detections(fused, unfused)
    shares = [h / n if n else 1.0 for h, n in zip(hits, counts)]
    moved = sum(len(g['scores_3d']) != len(w['scores_3d'])
                for g, w in zip(fused, unfused))
    cfg = Config.fromfile(cfg_file)
    agree, least, n_out, n_el, worst, median = fused_forward_agreement(
        cfg, ckpt, build_dataset(cfg.data['test']),
        cfg.data['samples_per_gpu'])
    objs = sorted(os.listdir(show))
    print(f'fused eval: eval entry --fuse-conv-bn --show-dir, '
          f'{fused_line[0]}, {seconds:.3f} s in all; {counts[0]} detections '
          f'against {counts[1]} unfused ({moved} of {len(fused)} scenes '
          f'with another count), {hits[0]} and {hits[1]} matched '
          f'({shares[0]:.4%} and {shares[1]:.4%}, bound '
          f'{FUSED_MATCH_SHARE:.0%}); the folded forward on the first val '
          f'batch: of each of its {n_out} outputs ({n_el} values) at least '
          f'{agree:.4%} within {FUSED_BOUND} of the unfused ({least}; bound '
          f'{FUSED_AGREE_SHARE:.0%}), largest difference {worst:.3e}, median '
          f'{median:.3e}; {len(objs)} .obj files ('
          f'{sum(os.path.getsize(os.path.join(show, f)) for f in objs) / 2**20:.1f}'
          f' MiB); launches {launches}', flush=True)
    if min(shares) < FUSED_MATCH_SHARE or agree < FUSED_AGREE_SHARE:
        raise AssertionError('fused eval: the folded model disagrees')
    if len(objs) != 3 * len(unfused) or not all(
            os.path.getsize(os.path.join(show, f)) for f in objs
            if not f.endswith('_pred.obj')):
        raise AssertionError(f'fused eval: {len(objs)} .obj files')
    return launches


def run_aug_test(model, dev, kernels):
    """``engine/aug_test.py::aug_test_3d`` on the serving model, a request
    of batch 2 x 20,000 points and 800x1344: twice a request's launches
    and the merge's one K8 (``LAUNCHES_AUG_TEST``), latency, the merged
    detections finite and the merge's K8 keep mask equal to the plain
    version's on the same detections.  Returns its launches."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    from demf_tpu_torch.engine.aug_test import (NMS_ROWS, aug_test_3d,
                                                flip_batch, merge_nms,
                                                unflip_boxes)
    batch = batch_to_device(zoo.synth_demf_batch(
        2, p=20000, hw=(800, 1344), valid_hw=(784, 1312), seed=0), dev)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = aug_test_3d(model, batch, nms_thr=AUG_NMS_THR)
    torch.cuda.synchronize()
    latency = (time.perf_counter() - t0) * 1e3
    launched = {n: k.launches for n, k in kernels.items()}
    if launched != LAUNCHES_AUG_TEST:
        raise AssertionError(f'aug test launched {launched}, expected '
                             f'{LAUNCHES_AUG_TEST}')
    for key in ('boxes_3d', 'scores_3d'):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f'aug test: non-finite {key}')
    t0 = time.perf_counter()
    aug_test_3d(model, batch, nms_thr=AUG_NMS_THR)
    torch.cuda.synchronize()
    again = (time.perf_counter() - t0) * 1e3
    # the merge's input, once more, through K8 and through its plain version
    eval_step = make_eval_step(model)
    dets = [eval_step(batch), dict(eval_step(flip_batch(batch)))]
    dets[1]['boxes_3d'] = unflip_boxes(dets[1]['boxes_3d'])
    cat = {k: torch.cat([d[k] for d in dets], 1)
           for k in ('boxes_3d', 'scores_3d', 'labels_3d', 'valid')}
    args = (cat['boxes_3d'], cat['scores_3d'], cat['labels_3d'],
            cat['valid'], AUG_NMS_THR)
    keep = merge_nms(*args)
    plain = merge_nms(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    if not torch.equal(keep.cpu(), plain) or not torch.equal(
            keep & cat['valid'], out['valid']):
        raise AssertionError('aug test: the merge differs from its plain '
                             'version or from the aug test\'s')
    m = cat['valid'].shape[1]
    half = m // 2
    print(f'aug test: flip ensemble of a request (batch 2, 20000 points, '
          f'800x1344), latency {latency:.3f} ms (host clock; again '
          f'{again:.3f} ms), {int(cat["valid"].sum())} detections of the two '
          f'augmentations merged to {int(out["valid"].sum())} '
          f'({int(out["valid"][:, :half].sum())} direct, '
          f'{int(out["valid"][:, half:].sum())} flipped), {m} a scene'
          + (f' cut into (scene, class) rows of at most {NMS_ROWS}'
             if m > NMS_ROWS else '') +
          f'; K8\'s merge equal to its plain version; launches {launched}',
          flush=True)
    return launched


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card only',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from demf_tpu_torch import ops, zoo
    from demf_tpu_torch.engine import batch_to_device, make_eval_step
    from demf_tpu_torch.ops import _cuda

    dev = torch.device('cuda', 0)
    name = torch.cuda.get_device_name(0)
    print(f'device: {name}, count {torch.cuda.device_count()}, torch '
          f'{torch.__version__}, cuda {torch.version.cuda}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f'nvidia-smi: {smi.stdout.strip().splitlines()[0]}')

    t0 = time.perf_counter()
    info = _cuda.build_info()
    print(f'build: {"built" if info["built"] else "reused"} '
          f'{info["path"]} in {info["seconds"]:.2f} s (nvcc), '
          f'{time.perf_counter() - t0:.2f} s with load')
    log = info['path'][:-3] + '.log'
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if 'registers' in line or 'Compiling entry' in line:
                    print('  ptxas:', line.strip())

    rng = np.random.RandomState(0)
    measured = {'fps': check_fps(dev, rng),
                'ball_query': check_ball_query(dev, rng),
                'msda': check_msda(dev, rng),
                'msda_backward': check_msda_backward(dev, rng),
                'nms3d': check_nms(dev),
                'box_count': check_box_count(dev),
                'nms2d': check_nms2d(dev),
                'roi_align': check_roi_align(dev)}
    measured['msda_bf16'], measured['msda_backward_bf16'] = \
        check_msda_bf16(dev, rng)
    measured.update(check_roi_align_bf16(dev))
    kernels = ops.kernels()
    probed, probe_launches = run_probes(dev, rng, kernels)
    measured.update(probed)

    t0 = time.perf_counter()
    model = with_size_prior(zoo.build_detector('demf/demf_votenet.py',
                                               device=dev, seed=0))
    print(f'model: DeMF-VoteNet full width, '
          f'{sum(p.numel() for p in model.parameters())} parameters, built '
          f'in {time.perf_counter() - t0:.2f} s')
    check_reference(model, dev)

    eval_step = make_eval_step(model)
    for k in kernels.values():
        k.launches = 0
    for seed in REQUESTS:
        before = {n: k.launches for n, k in kernels.items()}
        torch.cuda.reset_peak_memory_stats()
        batch = zoo.synth_demf_batch(2, p=20000, hw=(800, 1344),
                                     valid_hw=(784, 1312), seed=seed)
        t0 = time.perf_counter()
        det = eval_step(batch_to_device(batch, dev))
        torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) * 1e3
        launched = {n: k.launches - before[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_REQUEST:
            raise AssertionError(f'request {seed} launched {launched}, '
                                 f'expected {LAUNCHES_PER_REQUEST}')
        if tuple(det['boxes_3d'].shape) != (2, 5120, 7):
            raise AssertionError(f'boxes_3d {tuple(det["boxes_3d"].shape)}')
        for key in ('boxes_3d', 'scores_3d'):
            if not torch.isfinite(det[key]).all():
                raise AssertionError(f'non-finite {key} in request {seed}')
        print(f'request {seed}: latency {latency:.3f} ms (host clock, '
              f'batch 2, 20000 points, 800x1344), '
              f'{int(det["valid"].sum())} valid detections, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, '
              f'launches {launched}')

    profile_request(eval_step, batch_to_device(batch, dev))
    # an eval batch of the dataset path: 16 scenes (its first run at this
    # shape is not timed)
    batch = batch_to_device(zoo.synth_demf_batch(
        16, p=20000, hw=(800, 1344), valid_hw=(784, 1312), seed=3), dev)
    eval_step(batch)
    profile_request(eval_step, batch)
    del eval_step, batch
    aug_launches = run_aug_test(model, dev, kernels)
    serving_bf16 = run_serving_bf16(model, dev, kernels)
    del model
    torch.cuda.empty_cache()
    check_train_reference(dev)
    launches, first_step, measured['vote_targets'] = run_training_path(
        dev, kernels)
    by_path = {'training': dict(launches), 'probes': probe_launches,
               'serving_bf16': serving_bf16, 'aug_test': aug_launches}
    by_path['launcher_step'] = run_launcher_path(kernels)
    by_path['two_rank_step'] = run_two_rank_step(kernels)
    by_path['training_bf16'] = run_training_bf16(dev, kernels, first_step)
    launches.update(probe_launches)
    by_path['dataset'], by_path['fused_eval'] = run_dataset_path(kernels)
    launches['nms3d'] = by_path['dataset']['nms3d']
    launches['box_count'] = by_path['dataset']['box_count']
    by_path['pretrain'] = run_pretrain_path(dev, kernels)
    # K4's row is the pretrain step's shape, so its launches are that path's
    launches['msda_backward'] = by_path['pretrain']['msda_backward']
    by_path['pretrain_bf16'] = run_pretrain_bf16(dev, kernels)
    # K3 bf16's row is a request's encoder shape, K4 bf16's the pretrain
    # step's: their launches are those paths'
    launches['msda_bf16'] = serving_bf16['msda_bf16']
    launches['msda_backward_bf16'] = \
        by_path['pretrain_bf16']['msda_backward_bf16']
    by_path.update(run_votenet_path(dev, kernels))
    by_path.update(run_imvotenet_path(dev, kernels))
    # K10's and K11's rows are a request's shapes: their launches are the
    # ImVoteNet requests'
    launches['nms2d'] = by_path['imvotenet_serving']['nms2d']
    launches['roi_align'] = by_path['imvotenet_serving']['roi_align']
    # K12's row is the image-only step's shape: its launches are its steps'
    measured['roi_align_backward'], frcnn = run_frcnn_path(dev, kernels)
    by_path.update(frcnn)
    launches['roi_align_backward'] = \
        by_path['frcnn_step']['roi_align_backward']
    by_path['mmcv_eval'] = run_mmcv_checkpoint(dev, kernels)
    # K11 bf16's row is a request's shape: its launches are the bf16
    # ImVoteNet requests'; K12 bf16's the bf16 image-only steps'
    launches['roi_align_bf16'] = \
        by_path['imvotenet_serving_bf16']['roi_align_bf16']
    launches['roi_align_backward_bf16'] = \
        by_path['frcnn_step_bf16']['roi_align_backward_bf16']
    by_path.update(run_device_pipeline(dev, kernels))
    sparse_rows, fcaf3d = run_fcaf3d_path(dev, kernels)
    measured.update(sparse_rows)
    by_path.update(fcaf3d)
    by_path.update(run_demf_fcaf3d_path(dev, kernels))
    # K13-K15's rows are an FCAF3D request's own calls: their launches are
    # its; K14 bf16's the bf16 request's
    for n in ('kernel_map', 'sparse_conv', 'sparse_conv_plan',
              'nms3d_rotated'):
        launches[n] = by_path['fcaf3d_serving'][n]
    launches['sparse_conv_bf16'] = \
        by_path['fcaf3d_serving_bf16']['sparse_conv_bf16']
    train_rows, train = run_fcaf3d_train_path(dev, kernels)
    measured.update(train_rows)
    by_path.update(train)
    by_path.update(run_demf_fcaf3d_train_path(dev, kernels))
    # K14 on reverse tables, K16 and K17 (forward and backward): launches
    # of a FCAF3D train step, rows from that step's own calls (bf16: the
    # bf16 step's); K14's row carries them as its backward.  K18's launches
    # and row are the DeMF-VoteNet training path's
    for n in ('sparse_conv_backward', 'sparse_conv_dweights',
              'sparse_max_pool', 'sparse_max_pool_backward'):
        launches[n] = by_path['fcaf3d_train'][n]
        launches[f'{n}_bf16'] = by_path['fcaf3d_train_bf16'][f'{n}_bf16']
    measured['sparse_conv']['backward_launches'] = \
        by_path['fcaf3d_train']['sparse_conv_backward']

    table = [dict(name=n, route='cuda', source=SOURCES[n],
                  replaces=REPLACES[n], launches=launches[n],
                  launches_by_path={k: v.get(n, 0)
                                    for k, v in by_path.items()},
                  **measured[n])
             for n in kernels]
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
