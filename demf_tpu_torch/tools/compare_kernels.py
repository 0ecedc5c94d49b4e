"""K1 (FPS), K2 (ball query), K3 (MSDA forward), K4 (MSDA backward), K6
(slot fold), K7 (M-form sampler), K9 (box count), K10 (batched 2D NMS),
K11 (pyramid RoIAlign), K12 (its backward), K13 (the kernel map), K14
(the sparse convolution) and K15 (the class-wise rotated NMS) of this tree
against the same kernels of another commit, in turns, on one card:

    mkdir -p build/parent && git archive <commit> demf_tpu_torch | \\
        tar -x -C build/parent
    python -m demf_tpu_torch.tools.compare_kernels --parent build/parent

``--parent`` is a directory that holds the other commit's
``demf_tpu_torch``.  Its ``ops`` package is loaded beside this tree's under
a name of its own and builds its kernels from its own sources, so each
side goes through its own wrapper (``furthest_point_sample_cuda``,
``ball_query_cuda``, ``msda_cuda``, ``msda_backward_cuda``,
``weighted_slot_fold_batched`` / ``slot_major_fold``,
``mform_sample_cuda``, ``batched_nms_2d_cuda``, ``pyramid_roi_align_cuda``,
``pyramid_roi_align_backward_cuda``, ``sparse_conv_cuda``), whatever C
interface lies below.  At
every shape of the main paths (K7: the four levels of
``bench_msda_matmul``, bf16 and f32) each side is timed
twice, in the order parent, this tree, this tree, parent, on tensors made
beforehand;
K1's and K2's picks and K7's outputs must be equal (K7's to the plain
version's too) and K3's outputs within 1e-5 of the plain version's largest.
K4 runs at the decoder's shapes (batch 16 of 256 proposals with 2 points,
batch 4 of 300 queries with 4) on locations over the whole map, crowded
round 16 centres a scene and piled on one place
(``tools.decoder_sampling_locations``), and at the encoder's at batch 2
and 4 on the same three kinds of locations as K3; its three gradients must
lie within 1e-5 of the largest of the plain version's autograd on both
sides.  At the decoder's shapes each side's kernels a call with their
device ms and the memory a call takes are printed, and this tree's d_value
must be the same bits in two calls and equal
``ops/msda.py::msda_backward_rows_plain``.  At the two decoder shapes on
whole-map locations it runs again on a bf16 value and bf16 ``grad_out``
(its bf16 entry; the row-owner route in this tree): on both sides d_value
within one bf16 step of the largest of the plain version's in bf16 and
within half a step of each value (and 1e-5 of the largest) of the float32
kernel's on the same rounded inputs, d_loc and d_aw within 1e-5 of the
largest; in this tree d_value the same bit for bit from call to call and
equal to ``ops/msda.py::msda_backward_rows_plain``; each side's kernels a
call and the memory a call takes beyond its inputs are printed.
K6 runs on one chunk of ``bench_msda_fold`` (16 slices x LP 16 x Q
22,528 rows of 128 channels) in both weight layouts ((LP, Q, 4) and
slot-major), rows in bf16 and f32; both sides must equal the plain fold.
K9 runs at a request's and an eval batch's shape (20,000 points, 512
boxes, batch 2 and 16) on spread and clustered points; a commit without
K9 stands in with the non-empty-box test its ``multiclass_nms_3d`` ran (a
Python loop of its ``core/boxes.py::points_in_boxes`` over the scenes),
and the masks ``count > 5`` must be equal.  Each side's launches in one
call are printed, and two bounds: all pairs tested, and only the pairs
these inputs need (``tools.box_pairs_in_reach``; the bytes where larger).
K10 runs at the path's shapes (the RPN's 4,390 candidates in 5 level
groups and the R-CNN's 10,000 in 10 class groups, batch 16 and 2) and at
its limit of 16,384; both sides' keep masks must equal the plain
version's.  K11 runs at 1,000 RoIs a scene into (7, 7, 256) from the four
levels of a 608x832 image, batch 16 and 2; both sides' outputs must equal
the plain version's bit for bit, and the share of the byte bound is
printed.  K12 runs at the image-only step's shape (512 RoIs a scene,
(7, 7, 256) bins, batch 2 and 16) on RoIs spread, crowded as the R-CNN's
sampler hands them over and piled onto one box (``tools/roi_cases.py``);
each side's largest difference from the plain version's autograd (within
1e-5 of the largest gradient) and whether two of its calls give the same
bits are printed, and this tree's kernels' device ms.
K14 runs on the 47 convolutions of a FCAF3D request (full width, 2 scenes
of 100,000 points, seeded weights, norms calibrated: their own features,
tables and weights) summed, in float32 and in bf16, and on a dense cube
and a scattered level at layers 1, 3 and 4's widths
(``tools/sparse_cases.py``); this tree's calls make their tables' row
plans anew inside the timed call (once a table, as the model does), a
parent without plans goes as it is.  Every output of both sides must lie
within 1e-5 of the plain version's largest (bf16: one bf16 step); the
GFLOP of the taps that exist and of those this tree computes are printed,
and this tree's device ms of the request's convolutions by shape.
K13 runs on a FCAF3D request's tables (the same request) at the functions
the model calls, the key tables and offsets included: the parent's
``neighbor_table_batched`` / ``transposed_table`` calls as its model made
them (17) against this tree's ``kernel_tables`` launches (7); the tables
must be equal, and each side's kernels a request and their device ms are
printed.  K15 runs through both ``rotated_nms_classwise`` (the model's
call, no IoU matrix) on the request's call and on spread, piled,
coincident, apart and far boxes (``tools/nms_cases.py``) at its shape;
this tree's masks must equal the plain sweep fed its own IoUs, and each
side's kernels a call with their device ms are printed.
``--parent-only`` times the parent alone (K13 and K15): its numbers
before this tree's are timed.
K16 (``sparse_dweights``) and K14 on reverse tables
(``sparse_conv_backward``) run on the calls of one FCAF3D train step
(full width, 8 scenes of 100,000 points, seeded weights, the GT boxes
moved where the voxels are kept, as ``chip_smoke.py`` trains it): their
own features or output gradients, tables, plans and (transposed)
weights, summed, in float32 and in bf16 (the same calls rounded); each
side's results within 1e-5 of the largest of the plain version's (K14
bf16: one bf16 step), K16's the same bits on two calls; this tree's and
the parent's device ms by shape.  A parent whose K16 or K14-backward
wrapper refuses bf16 is timed on float32 only (K14-backward in bf16
through its forward's bf16 entry, the same kernel).
K2 runs at two densities: points drawn over a cube of 6 m (about 3 in the
first SA module's ball) and over one of 2 m with an eighth of them twice
(about 84 in that ball, so every center fills its K slots and equal
distances occur).  The encoder's
shape is timed with locations drawn over the whole map and with the
encoder's own (``tools.encoder_sampling_locations``): offsets of the
module's initial grid with noise of 0.5 pixels, as a model has them before
training, and with noise of 4 pixels, which scatters a share of the
samples out of the kernel's windows as learned offsets may.  Without
``--parent`` only this tree is timed.  ``--sweep`` also times this tree's
K1 at every cluster size and block size that holds the points, K2 at
every block shape and three tile sizes, K7 at several tile and block
sizes, and K16 at grids of 2 to 32 blocks an SM: the numbers behind
``ops.sampling.fps_launch_shape``,
``ops.grouping.ball_query_launch_shape``,
``ops.mform.mform_launch_shape`` and ``ops.sparse.dweights_chunk``.  ``--only`` names the kernels to run
(``fps,ball_query,msda,msda_backward,mform,msda_fold,box_count,nms2d,
roi_align,roi_align_backward,sparse_conv,kernel_map,nms3d_rotated,
sparse_dweights,sparse_conv_backward,sparse_max_pool,vote_targets``).
K17 (``sparse_max_pool``) runs on the stem pool's call of the same FCAF3D
train step (its coordinates, validity and rows; the output gradient drawn
from a seed), float32 and bf16 (the rows rounded): each side's
``sparse_max_pool_batched`` forward alone and forward + backward in turns,
each side's device ms by kernel and its pool's device ms a direction (its
kernels and fills), and both sides' outputs and gradients the same bits.
K18 (``vote_targets``) runs on a stage-2 step's vote-target call (16
scenes of 20,000 points of ``zoo.synth_points_batch``, 64 GT slots, 3
slots a point): each side's ``models/target_assign.py::_vote_targets`` in
turns, the targets the same bits, each side's device ms by kernel and its
launches a call.  Without ``--parent`` their other side is this tree's
plain route.  Prints its lines, writes
them as JSON to ``--out`` when given, and returns the rows.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

import torch

from ..core import boxes as box_ops
from ..ops import (box_count, grouping, mform, msda, msda_fold, nms2d,
                   roi_align, sampling, sparse)
from ..ops._cuda import DTYPE_CODES, SM_COUNT, SMEM_PER_BLOCK
from ..ops.gather_rows import gather_rows
from . import (bench_msda_fold, bench_msda_matmul, bf16_err, bound_ms,
               box_pairs_in_reach, call_bytes, cuda_device,
               decoder_sampling_locations, device_kernels,
               encoder_sampling_locations, same_bits, time_ms,
               vote_target_bound)
from .nms_cases import box_count_case, nms2d_case
from .roi_cases import (ROI_KINDS, ROI_STRIDES, SAMPLED_ROIS, k12_case,
                        roi_case)
from .sparse_cases import (SPARSE_LEVELS, calibrate_batch_norms, conv_flops,
                           level, tolerance)

# (scenes, points, picks) of the point branch's four SA modules and the
# vote aggregation, at the training batch and the serving batch
FPS_SHAPES = [(b, n, k) for b in (16, 2) for n, k in (
    (20000, 2048), (2048, 1024), (1024, 512), (512, 256), (1024, 256))]
# (points, centers, picks, radius) of the four SA modules and the vote
# aggregation (configs/demf/demf_votenet.py), and the two densities: (name,
# half the cube's side in metres, share of the points that occur twice)
BALL_SHAPES = ((20000, 2048, 64, 0.2), (2048, 1024, 32, 0.4),
               (1024, 512, 16, 0.8), (512, 256, 16, 1.2),
               (1024, 256, 16, 0.3))
BALL_DENSITIES = (('sparse', 3.0, 0.0), ('dense', 1.0, 0.125))
MSDA_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))
# (name, scenes, points a level, noise of the encoder's offsets in pixels
# or None); queries are 256 proposals or the tokens
MSDA_CASES = (('decoder', 16, 2, None), ('decoder', 2, 2, None),
              ('encoder, locations over the whole map', 2, 4, None),
              ('encoder, its own locations, noise 0.5 px', 2, 4, 0.5),
              ('encoder, its own locations, noise 4 px', 2, 4, 4.0))


# K4: (name, scenes, queries or None for the tokens, points, the
# decoder's locations (``tools.decoder_sampling_locations``) or the noise
# of the encoder's)
MSDA_BACKWARD_CASES = tuple(
    (f'decoder, {where} locations', b, q, p, where)
    for b, q, p in ((16, 256, 2), (4, 300, 4))
    for where in ('whole map', 'crowded', 'piled')) + (
    ('encoder, locations over the whole map', 2, None, 4, None),
    ('encoder, its own locations, noise 0.5 px', 2, None, 4, 0.5),
    ('encoder, its own locations, noise 4 px', 2, None, 4, 4.0),
    ('encoder, locations over the whole map', 4, None, 4, None),
    ('encoder, its own locations, noise 0.5 px', 4, None, 4, 0.5),
    ('encoder, its own locations, noise 4 px', 4, None, 4, 4.0))

KERNELS = ('fps', 'ball_query', 'msda', 'msda_backward', 'mform',
           'msda_fold', 'box_count', 'nms2d', 'roi_align',
           'roi_align_backward', 'sparse_conv', 'kernel_map', 'nms3d_rotated',
           'sparse_dweights', 'sparse_conv_backward', 'sparse_max_pool',
           'vote_targets')
# K18: the vote targets' call of a stage-2 step (scenes, points, GT slots,
# gt_per_seed)
VOTE_TARGETS_CALL = (16, 20000, 64, 3)
# the kernels whose comparison can time the parent alone (--parent-only)
PARENT_ONLY = ('kernel_map', 'nms3d_rotated')
# K9: (scenes, points, boxes) of a request and of an eval batch
BOX_COUNT_SHAPES = ((2, 20000, 512), (16, 20000, 512))
# K10: (scenes, layout, candidates, IoU threshold) of the RPN's and the
# R-CNN's calls at a step's and a request's batch, and the limit
NMS2D_SHAPES = ((16, 'rcnn', 10000, 0.5), (16, 'rpn', 4390, 0.7),
                (2, 'rcnn', 10000, 0.5), (2, 'rpn', 4390, 0.7),
                (2, 'random', 16384, 0.7))


def parent_ops(parent):
    """The other commit's ``ops.sampling``, ``ops.grouping``, ``ops.msda``,
    ``ops.mform``, ``ops.msda_fold``, ``core.boxes``, ``ops.nms2d`` and
    ``ops.roi_align``, its ``demf_tpu_torch`` loaded as the package
    ``demf_parent``; this tree's without a parent."""
    if parent is None:
        return (sampling, grouping, msda, mform, msda_fold, box_ops, nms2d,
                roi_align)
    path = os.path.join(parent, 'demf_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        'demf_parent', os.path.join(path, '__init__.py'),
        submodule_search_locations=[path])
    package = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = package
    spec.loader.exec_module(package)
    mods = tuple(importlib.import_module(f'demf_parent.ops.{name}')
                 for name in ('sampling', 'grouping', 'msda', 'mform',
                              'msda_fold', 'nms2d', 'roi_align'))
    boxes = importlib.import_module('demf_parent.core.boxes')
    return mods[:5] + (boxes,) + mods[5:]


def in_turns(parent, change, iters):
    """ms of parent, change, change, parent."""
    return [time_ms(fn, iters) for fn in (parent, change, change, parent)]


def compare_fps(old, dev, sweep):
    rows = []
    gen = torch.Generator(dev).manual_seed(0)
    for b, n, k in FPS_SHAPES:
        xyz = torch.rand((b, n, 3), generator=gen, device=dev) * 6 - 3
        want = old.furthest_point_sample_cuda(xyz, k)
        equal = torch.equal(want, sampling.furthest_point_sample_cuda(xyz, k))
        ms = in_turns(lambda: old.furthest_point_sample_cuda(xyz, k),
                      lambda: sampling.furthest_point_sample_cuda(xyz, k), 5)
        row = dict(kernel='fps', b=b, n=n, k=k, equal=equal,
                   launch_shape=sampling.fps_launch_shape(n),
                   parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
        print(f'K1 fps ({b}, {n}) -> {k}: parent {ms[0]:.4f} / {ms[3]:.4f} '
              f'ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms (cluster, threads '
              f'{row["launch_shape"]}), picks equal: {equal}', flush=True)
        if not equal:
            raise AssertionError('the two FPS kernels pick other points')
        if sweep:
            row['sweep'] = sweep_fps(xyz, k, want)
        rows.append(row)
    return rows


def sweep_fps(xyz, k, want):
    """ms of this tree's K1 by (cluster, threads)."""
    b, n, _ = xyz.shape
    out = torch.empty_like(want)
    found = {}
    for cluster in (1, 2, 4, 8):
        for threads in (128, 256, 512):
            if -(-(-(-n // cluster)) // threads) > 16:
                continue

            def run():
                sampling.FPS_KERNEL(xyz.data_ptr(), out.data_ptr(), b, n, k,
                                    cluster, threads)

            run()
            if not torch.equal(out, want):
                raise AssertionError(f'FPS picks differ at cluster '
                                     f'{cluster}, threads {threads}')
            found[f'{cluster}x{threads}'] = time_ms(run, 3)
    print('   sweep (cluster x threads: ms): ' + ', '.join(
        f'{key}: {ms:.4f}' for key, ms in found.items()), flush=True)
    return found


def ball_inputs(b, n, m, half_side, twice, gen, dev):
    """(B, N, 3) points uniform over a cube, the share ``twice`` of them
    copies of the first ones; the first M are the centers."""
    pts = (torch.rand((b, n, 3), generator=gen, device=dev) * 2 - 1) * \
        half_side
    copies = int(n * twice)
    if copies:
        pts[:, n // 2:n // 2 + copies] = pts[:, :copies]
    return pts, pts[:, :m].contiguous()


def compare_ball_query(old, dev, sweep):
    rows = []
    gen = torch.Generator(dev).manual_seed(0)
    for density, half_side, twice in BALL_DENSITIES:
        for b in (16, 2):
            for n, m, k, r in BALL_SHAPES:
                pts, ctr = ball_inputs(b, n, m, half_side, twice, gen, dev)
                want = old.ball_query_cuda(r, k, pts, ctr)
                got = grouping.ball_query_cuda(r, k, pts, ctr)
                equal = torch.equal(want, got)
                d2 = grouping.sqdist(ctr, pts)
                in_ball = (d2 < r * r).sum(-1).float().mean().item()
                del d2
                # 50 runs a turn: the small calls take ~10 us on the card
                ms = in_turns(lambda: old.ball_query_cuda(r, k, pts, ctr),
                              lambda: grouping.ball_query_cuda(r, k, pts, ctr),
                              50)
                row = dict(kernel='ball_query', density=density, b=b, n=n,
                           m=m, k=k, r=r, in_ball=in_ball, equal=equal,
                           launch_shape=grouping.ball_query_launch_shape(
                               b, m, n, k),
                           parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
                print(f'K2 ball_query {density} (B {b}, M {m}, N {n}, K {k}, '
                      f'r {r}; {in_ball:.1f} points a ball): parent '
                      f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} '
                      f'/ {ms[2]:.4f} ms (warps, centers a warp, list, tile '
                      f'{row["launch_shape"]}), picks equal: {equal}',
                      flush=True)
                if not equal:
                    raise AssertionError('the two ball query kernels pick '
                                         'other points')
                if sweep:
                    row['sweep'] = sweep_ball_query(pts, ctr, k, r, want)
                rows.append(row)
    return rows


def sweep_ball_query(pts, ctr, k, r, want):
    """ms of this tree's K2 by (warps, centers a warp, tile)."""
    b, n, _ = pts.shape
    m = ctr.shape[1]
    cap = grouping.ball_query_launch_shape(b, m, n, k)[2]
    out = torch.empty_like(want)
    found = {}
    for warps, per_warp in ((16, 2), (8, 8), (8, 4), (8, 2), (4, 8), (4, 4),
                            (4, 2), (4, 1), (2, 4), (2, 2), (2, 1), (1, 2),
                            (1, 1)):
        for tile in (512, 1024, 2048):
            if tile >= 2 * n or grouping.ball_query_smem_bytes(
                    warps, per_warp, cap, tile) > SMEM_PER_BLOCK:
                continue

            def run():
                grouping.BALL_QUERY_KERNEL(
                    pts.data_ptr(), ctr.data_ptr(), out.data_ptr(), b, n, m,
                    k, r * r, warps, per_warp, cap, tile)

            run()
            if not torch.equal(out, want):
                raise AssertionError(f'ball query picks differ at {warps} '
                                     f'warps x {per_warp}, tile {tile}')
            found[f'{warps}x{per_warp}/{tile}'] = time_ms(run, 5)
    best = sorted(found.items(), key=lambda kv: kv[1])[:6]
    print('   sweep, best of (warps x centers a warp / tile: ms): ' +
          ', '.join(f'{key}: {ms:.4f}' for key, ms in best), flush=True)
    return found


def compare_mform(old, dev, sweep):
    """K7 at ``bench_msda_matmul``'s four levels, bf16 and f32."""
    rows = []
    bh, q, hd, slots = (bench_msda_matmul.BH, bench_msda_matmul.Q,
                        bench_msda_matmul.HD, bench_msda_matmul.SLOTS)
    for dtype in (torch.bfloat16, torch.float32):
        for n, label in bench_msda_matmul.LEVELS:
            plane, idx16, w16 = bench_msda_matmul.make_inputs(
                bh, n, q, hd, slots, dev)
            plane, w16 = plane.to(dtype), w16.to(dtype)
            want = old.mform_sample_cuda(plane, idx16, w16)
            got = mform.mform_sample_cuda(plane, idx16, w16)
            equal = torch.equal(want, got) and torch.equal(
                got, mform.mform_sample_plain(plane, idx16, w16))
            bag = bench_msda_matmul.embedding_bag_inputs(plane, idx16, w16)
            library_ms = time_ms(
                lambda: bench_msda_matmul.mform_library(*bag, bh), 5)
            del bag
            ms = in_turns(lambda: old.mform_sample_cuda(plane, idx16, w16),
                          lambda: mform.mform_sample_cuda(plane, idx16, w16),
                          10)
            shape = mform.mform_launch_shape(
                slots, hd, plane.element_size(), w16.element_size())
            row = dict(kernel='mform', level=label, n=n, dtype=str(dtype),
                       equal=equal, launch_shape=shape, library_ms=library_ms,
                       parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
            print(f'K7 mform {label} N {n} {dtype}: parent {ms[0]:.4f} / '
                  f'{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms '
                  f'(queries a tile, threads {shape}), one '
                  f'embedding_bag call {library_ms:.4f} ms, equal to the '
                  f'parent\'s and the plain version\'s: {equal}', flush=True)
            if not equal:
                raise AssertionError('the M-form kernels disagree')
            if sweep:
                row['sweep'] = sweep_mform(plane, idx16, w16, want)
            rows.append(row)
    return rows


def sweep_mform(plane, idx16, w16, want):
    """ms of this tree's K7 by (queries a tile, threads)."""
    bh, n, hd = plane.shape
    _, k, q, _ = idx16.shape
    out = torch.empty_like(want)
    found = {}
    for shape in [(q_tile, threads) for q_tile in (64, 128, 256, 512)
                  for threads in (64, 128, 256, 512)]:

        def run():
            mform.MFORM_KERNEL(
                plane.data_ptr(), idx16.data_ptr(), w16.data_ptr(),
                out.data_ptr(), bh, n, k, q, hd, DTYPE_CODES[plane.dtype],
                DTYPE_CODES[w16.dtype], *shape)

        run()
        if not torch.equal(out, want):
            raise AssertionError(f'M-form outputs differ at {shape}')
        found['/'.join(map(str, shape))] = time_ms(run, 5)
    best = sorted(found.items(), key=lambda kv: kv[1])[:6]
    print('   sweep, best of (queries a tile / threads: ms): ' +
          ', '.join(f'{key}: {ms:.4f}' for key, ms in best), flush=True)
    return found


def compare_msda(old, dev):
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    gen = torch.Generator(dev).manual_seed(0)
    rows = []
    for name, b, p, noise in MSDA_CASES:
        q = 256 if name == 'decoder' else s
        value = torch.randn((b, s, 8, 32), generator=gen, device=dev)
        if noise is None:
            locs = torch.rand((b, q, 8, 4, p, 2), generator=gen,
                              device=dev) * 1.2 - 0.1
        else:
            locs = encoder_sampling_locations(shapes, b, 8, p, dev,
                                              jitter=noise)
        aw = torch.rand((b, q, 8, 4 * p), generator=gen, device=dev)
        aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p)
        want = msda.msda_plain(value, shapes, locs, aw)
        bound = 1e-5 * want.abs().max().item()
        errs = [(m.msda_cuda(value, shapes, locs, aw) - want).abs().max()
                .item() for m in (old, msda)]
        del want
        ms = in_turns(lambda: old.msda_cuda(value, shapes, locs, aw),
                      lambda: msda.msda_cuda(value, shapes, locs, aw), 10)
        rows.append(dict(kernel='msda', case=name, b=b, q=q, p=p,
                         parent_err=errs[0], err=errs[1], bound=bound,
                         parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]]))
        print(f'K3 msda {name} (B {b}, Q {q}, P {p}): parent {ms[0]:.4f} / '
              f'{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms; max '
              f'err vs plain: parent {errs[0]:.3e}, this tree {errs[1]:.3e} '
              f'(bound {bound:.3e})', flush=True)
        if not max(errs) <= bound:
            raise AssertionError('an MSDA kernel disagrees with plain')
    return rows


def compare_msda_backward(old, dev):
    """K4 at the shapes the paths launch it, each side through its own
    wrapper (the parent's zero-fill of d_value included).  At the decoders'
    shapes also each side's kernels a call with their device ms and the
    memory a call takes, and whether this tree's d_value is the same bits
    in two calls and equals ``ops/msda.py::msda_backward_rows_plain``."""
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    gen = torch.Generator(dev).manual_seed(0)
    rows = []
    for name, b, q, p, where in MSDA_BACKWARD_CASES:
        decoder = q is not None
        q = q or s
        value = torch.randn((b, s, 8, 32), generator=gen, device=dev)
        if decoder:
            locs = decoder_sampling_locations(shapes, b, q, 8, p, dev, where)
        elif where is None:
            locs = torch.rand((b, q, 8, 4, p, 2), generator=gen,
                              device=dev) * 1.2 - 0.1
        else:
            locs = encoder_sampling_locations(shapes, b, 8, p, dev,
                                              jitter=where)
        aw = torch.rand((b, q, 8, 4 * p), generator=gen, device=dev)
        aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p)
        grad = torch.randn((b, q, 256), generator=gen, device=dev)
        ins = [t.detach().requires_grad_() for t in (value, locs, aw)]
        want = torch.autograd.grad(
            msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
        del ins
        bounds = [1e-5 * w.abs().max().item() for w in want]
        errs = [[(g - w).abs().max().item() for g, w in zip(
            m.msda_backward_cuda(value, shapes, locs, aw, grad), want)]
            for m in (old, msda)]
        del want
        row = dict(kernel='msda_backward', case=name, b=b, q=q, p=p,
                   parent_err=errs[0], err=errs[1], bounds=bounds)
        more = ''
        if decoder:
            first = msda.msda_backward_cuda(value, shapes, locs, aw, grad)[0]
            again = msda.msda_backward_cuda(value, shapes, locs, aw, grad)[0]
            row['same_bits'] = torch.equal(first, again)
            del again
            row['equal_to_rows_plain'] = torch.equal(
                first, msda.msda_backward_rows_plain(value, shapes, locs, aw,
                                                     grad))
            del first
            row['parent_by_kernel'], row['by_kernel'] = [device_kernels(
                lambda m=m: m.msda_backward_cuda(value, shapes, locs, aw,
                                                 grad)) for m in (old, msda)]
            row['parent_bytes'], row['bytes'] = [call_bytes(
                lambda m=m: m.msda_backward_cuda(value, shapes, locs, aw,
                                                 grad)) for m in (old, msda)]
            more = (f'; memory a call beyond the inputs: parent '
                    f'{row["parent_bytes"] / 2 ** 20:.1f} MiB, this tree '
                    f'{row["bytes"] / 2 ** 20:.1f} MiB; this tree\'s d_value '
                    f'the same bits twice: {row["same_bits"]}, equal to '
                    f'msda_backward_rows_plain: {row["equal_to_rows_plain"]};'
                    f' device ms (launches) a call by kernel: parent '
                    f'{_ms_by_kernel(row["parent_by_kernel"])}, this tree '
                    f'{_ms_by_kernel(row["by_kernel"])}')
        ms = in_turns(
            lambda: old.msda_backward_cuda(value, shapes, locs, aw, grad),
            lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad),
            10)
        row.update(parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
        rows.append(row)
        fmt = ' / '.join(['{:.3e}'] * 3)
        print(f'K4 msda_backward {name} (B {b}, Q {q}, P {p}): parent '
              f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
              f'{ms[2]:.4f} ms; max err of d_value / d_loc / d_aw vs plain: '
              f'parent {fmt.format(*errs[0])}, this tree '
              f'{fmt.format(*errs[1])} (bounds {fmt.format(*bounds)}){more}',
              flush=True)
        if not all(e <= bd for side in errs for e, bd in zip(side, bounds)):
            raise AssertionError('an MSDA backward kernel disagrees with '
                                 'plain')
        if decoder and not (row['same_bits'] and row['equal_to_rows_plain']):
            raise AssertionError('the decoder\'s d_value is not the plain '
                                 'row order\'s, or not the same twice')
        del value, locs, aw, grad
        torch.cuda.empty_cache()
    return rows


BF16_STEP = 2.0 ** -7


def _ms_by_kernel(found):
    """'name ms (launches), ...' of ``tools.device_kernels``."""
    return ', '.join(f'{k} {ms:.4f} ({n:g})' for k, (n, ms) in found.items())


def compare_msda_backward_bf16(old, dev):
    """K4's bf16 entry at the decoders' shapes, each side through its own
    wrapper, checked as ``chip_smoke.py::check_msda_bf16`` checks it."""
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    gen = torch.Generator(dev).manual_seed(1)
    rows = []
    for name, b, q, p, where in MSDA_BACKWARD_CASES:
        if where != 'whole map':
            continue
        value = torch.randn((b, s, 8, 32), generator=gen,
                            device=dev).bfloat16()
        locs = torch.rand((b, q, 8, 4, p, 2), generator=gen,
                          device=dev) * 1.2 - 0.1
        aw = torch.rand((b, q, 8, 4 * p), generator=gen, device=dev)
        aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p)
        grad = torch.randn((b, q, 256), generator=gen, device=dev).bfloat16()
        ins = [t.detach().requires_grad_() for t in (value, locs, aw)]
        want = torch.autograd.grad(
            msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
        del ins
        ref = msda.msda_backward_cuda(value.float(), shapes, locs, aw,
                                      grad.float())
        errs = []
        for m in (old, msda):
            got = m.msda_backward_cuda(value, shapes, locs, aw, grad)
            side = [bf16_err(got[0], want[0], 0.0, BF16_STEP),
                    bf16_err(got[0], ref[0], BF16_STEP / 2, 1e-5)]
            side += [bf16_err(g, w, 0.0, 1e-5) for g, w in
                     zip(got[1:] + got[1:], want[1:] + ref[1:])]
            errs.append(side)
        del want, ref, got
        first = msda.msda_backward_cuda(value, shapes, locs, aw, grad)[0]
        again = msda.msda_backward_cuda(value, shapes, locs, aw, grad)[0]
        same = torch.equal(first, again)
        plain_order = torch.equal(first, msda.msda_backward_rows_plain(
            value, shapes, locs, aw, grad))
        del first, again
        by_kernel = [device_kernels(
            lambda m=m: m.msda_backward_cuda(value, shapes, locs, aw, grad))
            for m in (old, msda)]
        taken = [call_bytes(
            lambda m=m: m.msda_backward_cuda(value, shapes, locs, aw, grad))
            for m in (old, msda)]
        ms = in_turns(
            lambda: old.msda_backward_cuda(value, shapes, locs, aw, grad),
            lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad),
            10)
        row = dict(kernel='msda_backward_bf16', case=name, b=b, q=q, p=p,
                   parent_by_kernel=by_kernel[0], by_kernel=by_kernel[1],
                   parent_err=[e for e, _ in errs[0]],
                   err=[e for e, _ in errs[1]],
                   bounds=[bd for _, bd in errs[1]], same_bits=same,
                   equal_to_rows_plain=plain_order,
                   parent_bytes=taken[0], bytes=taken[1],
                   parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
        rows.append(row)
        print(f'K4 msda_backward bf16 {name} (B {b}, Q {q}, P {p}): parent '
              f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
              f'{ms[2]:.4f} ms; memory a call beyond the inputs: parent '
              f'{taken[0] / 2 ** 20:.1f} MiB, this tree '
              f'{taken[1] / 2 ** 20:.1f} MiB; d_value vs plain bf16 / vs the '
              f'f32 kernel, d_loc / d_aw vs plain: parent '
              f'{errs[0][0][0]:.3e} / {errs[0][1][0]:.3e}, {errs[0][2][0]:.3e}'
              f' / {errs[0][3][0]:.3e}, this tree {errs[1][0][0]:.3e} / '
              f'{errs[1][1][0]:.3e}, {errs[1][2][0]:.3e} / '
              f'{errs[1][3][0]:.3e} (bounds {errs[1][0][1]:.3e} / '
              f'{errs[1][1][1]:.3e}, {errs[1][2][1]:.3e} / '
              f'{errs[1][3][1]:.3e}); this tree\'s d_value the same bits '
              f'twice: {same}, equal to msda_backward_rows_plain: '
              f'{plain_order}; device ms (launches) a call by kernel: '
              f'parent {_ms_by_kernel(by_kernel[0])}, this tree '
              f'{_ms_by_kernel(by_kernel[1])}', flush=True)
        if not all(e <= bd for side in errs for e, bd in side):
            raise AssertionError('an MSDA backward bf16 kernel disagrees')
        if not (same and plain_order):
            raise AssertionError('the row-owner d_value is not the plain '
                                 'order\'s, or not the same twice')
        del value, locs, aw, grad
        torch.cuda.empty_cache()
    return rows


def compare_msda_fold(old, dev):
    """K6 on one chunk of the fold probe, both weight layouts, bf16 and f32
    rows; its bound: rows and weights read once, sums written once."""
    hd, lp, q = bench_msda_fold.HD, bench_msda_fold.LP, bench_msda_fold.Q
    plane, idx, w4 = bench_msda_fold.make_inputs(bench_msda_fold.CHUNK, dev)
    bf16_rows = gather_rows(plane, idx).view(-1, lp, q, 4 * hd)
    del plane, idx
    w4 = w4.view(-1, lp, q, 4)
    w4t = w4.permute(0, 1, 3, 2).float().contiguous()      # (BH, LP, 4, Q)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        r = bf16_rows.to(dtype)
        for layout, w, fold in (
                ('(LP, Q, 4)', w4, lambda m, r=r: m.weighted_slot_fold_batched(
                    r, w4, hd=hd)),
                ('slot-major', w4t, lambda m, r=r: m.slot_major_fold(r, w4t))):
            want = msda_fold.slot_fold_plain(
                r, w.to(dtype) if w is w4 else w.transpose(2, 3))
            equal = [torch.equal(fold(m), want) for m in (old, msda_fold)]
            ms = in_turns(lambda: fold(old), lambda: fold(msda_fold), 10)
            wbytes = w.numel() * (r.element_size() if w is w4 else 4)
            least, by = bound_ms(2 * r.numel(), r.numel() * r.element_size() +
                                 wbytes + want.numel() * 4)
            row = dict(kernel='msda_fold', layout=layout, dtype=str(dtype),
                       vector=msda_fold.fold_takes_vector_loads(r),
                       equal=equal, bound_ms=least, bound_by=by,
                       parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
            print(f'K6 msda_fold {layout} {dtype}, one chunk {tuple(r.shape)}: '
                  f'parent {ms[0]:.4f} / {ms[3]:.4f} ms, this tree '
                  f'{ms[1]:.4f} / {ms[2]:.4f} ms (vector kernel: '
                  f'{row["vector"]}), bound {least:.4f} ms ({by}), this tree '
                  f'at {least / min(ms[1:3]):.1%} of it; equal to the plain '
                  f'fold: parent {equal[0]}, this tree {equal[1]}', flush=True)
            if not all(equal):
                raise AssertionError('a fold kernel differs from plain')
            rows.append(row)
            del want
        del r
    return rows


def compare_box_count(old_boxes, dev, parent_has_k9):
    """K9 against the parent's: its kernel where it has one, else the
    non-empty-box test of its ``multiclass_nms_3d``, a Python loop of its
    ``points_in_boxes`` over the scenes."""
    rows = []
    for b, p, n in BOX_COUNT_SHAPES:
        for kind in ('spread', 'clustered'):
            points, boxes = (torch.from_numpy(a).to(dev) for a in
                             box_count_case(kind, b, p, n, seed=b))

            def before():
                if parent_has_k9:
                    return old_boxes(points, boxes) > 5
                return torch.stack([
                    old_boxes.points_in_boxes(points[i, :, :3],
                                              boxes[i]).sum(0) > 5
                    for i in range(b)])

            def after():
                return box_count.box_point_count_cuda(points, boxes) > 5

            equal = torch.equal(before(), after())
            counted = [lambda: old_boxes(points, boxes) if parent_has_k9
                       else before(),
                       lambda: box_count.box_point_count_cuda(points, boxes)]
            by_kernel = [device_kernels(fn) for fn in counted]
            launches = [round(sum(n for n, _ in found.values()))
                        for found in by_kernel]
            ms = in_turns(before, after, 5)
            nbytes = 4 * (points.numel() + boxes.numel() + b * n)
            least, by = bound_ms(12 * b * p * n, nbytes)
            needed = box_pairs_in_reach(points, boxes)
            culled, culled_by = bound_ms(12 * needed, nbytes)
            row = dict(kernel='box_count', kind=kind, b=b, p=p, n=n,
                       equal=equal, launches=launches,
                       parent_by_kernel=by_kernel[0], by_kernel=by_kernel[1],
                       parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                       bound_ms=least, bound_by=by, pairs_needed=needed,
                       culled_bound_ms=culled, culled_bound_by=culled_by)
            print(f'K9 box_count {kind} (B {b}, P {p}, N {n}): parent '
                  f'{"K9" if parent_has_k9 else "loop of points_in_boxes"} '
                  f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
                  f'{ms[2]:.4f} ms; kernels in one call: parent '
                  f'{launches[0]}, this tree {launches[1]}; device ms '
                  f'(launches) by kernel: parent '
                  f'{_ms_by_kernel(by_kernel[0])}, this tree '
                  f'{_ms_by_kernel(by_kernel[1])}; bound of all '
                  f'pairs {least:.6f} ms ({by}), of the {needed} pairs in '
                  f'reach {culled:.6f} ms ({culled_by}); masks equal: '
                  f'{equal}', flush=True)
            if not equal:
                raise AssertionError('the non-empty masks differ')
            rows.append(row)
    return rows


def compare_nms2d(old, dev):
    """K10 through both wrappers at ``NMS2D_SHAPES``; both sides' keep
    masks must equal the plain version's."""
    rows = []
    for b, layout, n, thr in NMS2D_SHAPES:
        boxes, scores, idxs, valid = (
            torch.from_numpy(a).to(dev) for a in nms2d_case(
                b, n, groups=5, seed=b, layout=layout))
        want = nms2d.batched_nms_2d_plain(boxes, scores, idxs, thr, valid)
        equal = [torch.equal(m.batched_nms_2d_cuda(boxes, scores, idxs, thr,
                                                   valid), want)
                 for m in (old, nms2d)]
        ms = in_turns(
            lambda: old.batched_nms_2d_cuda(boxes, scores, idxs, thr, valid),
            lambda: nms2d.batched_nms_2d_cuda(boxes, scores, idxs, thr,
                                              valid), 20)
        row = dict(kernel='nms2d', b=b, layout=layout, n=n, thresh=thr,
                   kept=int(want.sum()), valid=int(valid.sum()), equal=equal,
                   parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
        print(f'K10 nms2d ({b}, N {n}, {layout}, thr {thr}; kept '
              f'{row["kept"]} of {row["valid"]} valid): parent {ms[0]:.4f} / '
              f'{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms '
              f'through the wrappers; keep masks equal to the plain '
              f'version\'s: parent {equal[0]}, this tree {equal[1]}',
              flush=True)
        if not all(equal):
            raise AssertionError('a 2D NMS kernel differs from plain')
        rows.append(row)
    return rows


def compare_roi_align(old, dev):
    """K11 through both wrappers at (16 and 2) x 1,000 RoIs; both sides'
    outputs must equal the plain version's; its bound: the levels read
    once, the RoIs and levels, the output written once."""
    rows = []
    for b in (16, 2):
        feats, rois, lvl = roi_case(dev, b, seed=b)
        want = roi_align.pyramid_roi_align_plain(feats, rois, lvl,
                                                 ROI_STRIDES)
        equal = [torch.equal(m.pyramid_roi_align_cuda(feats, rois, lvl,
                                                      ROI_STRIDES), want)
                 for m in (old, roi_align)]
        least, by = bound_ms(50 * want.numel(), 4 * (
            sum(f.numel() for f in feats) + rois.numel() + lvl.numel() +
            want.numel()))
        del want
        ms = in_turns(
            lambda: old.pyramid_roi_align_cuda(feats, rois, lvl, ROI_STRIDES),
            lambda: roi_align.pyramid_roi_align_cuda(feats, rois, lvl,
                                                     ROI_STRIDES), 10)
        row = dict(kernel='roi_align', b=b, r=1000, equal=equal,
                   bound_ms=least, bound_by=by, parent_ms=[ms[0], ms[3]],
                   ms=[ms[1], ms[2]])
        print(f'K11 roi_align (B {b}, 1000 RoIs, out (7, 7, 256)): parent '
              f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
              f'{ms[2]:.4f} ms, bound {least:.4f} ms ({by}): parent at '
              f'{least / min(ms[0], ms[3]):.1%}, this tree at '
              f'{least / min(ms[1:3]):.1%} of it; equal to the plain '
              f'version: parent {equal[0]}, this tree {equal[1]}', flush=True)
        if not all(equal):
            raise AssertionError('a RoIAlign kernel differs from plain')
        rows.append(row)
    return rows


def compare_roi_align_backward(old, dev, sweep):
    """K12 through both wrappers at the image-only step's shape, batch 2
    and 16, on spread, crowded and piled RoIs: each side within 1e-5 of the
    largest gradient of the plain version's autograd, the same bits in two
    calls or not, both timed in turns; this tree's kernels' device ms by
    kernel.  ``sweep`` also times this tree at a few chunk lengths."""
    rows = []
    for b in (2, 16):
        for kind in ROI_KINDS:
            d_out, shapes, rois, lvl = k12_case(dev, b, kind, seed=b)
            want = roi_align.pyramid_roi_align_backward_plain(
                d_out, shapes, rois, lvl, ROI_STRIDES)
            scale = max(w.abs().max().item() for w in want)
            errs, same = [], []
            for m in (old, roi_align):
                got = m.pyramid_roi_align_backward_cuda(d_out, shapes, rois,
                                                        lvl, ROI_STRIDES)
                errs.append(max((g - w).abs().max().item()
                                for g, w in zip(got, want)))
                again = m.pyramid_roi_align_backward_cuda(
                    d_out, shapes, rois, lvl, ROI_STRIDES)
                same.append(all(torch.equal(g, a)
                                for g, a in zip(got, again)))
                del got, again
            del want
            torch.cuda.empty_cache()

            def tree(chunk=roi_align.K12_CHUNK):
                return roi_align.pyramid_roi_align_backward_cuda(
                    d_out, shapes, rois, lvl, ROI_STRIDES, chunk=chunk)

            ms = in_turns(lambda: old.pyramid_roi_align_backward_cuda(
                d_out, shapes, rois, lvl, ROI_STRIDES), tree, 20)
            by_kernel = device_kernels(tree)
            grad_numel = sum(n * h * w * c for n, h, w, c in shapes)
            least, by = bound_ms(50 * d_out.numel(),
                                 4 * (d_out.numel() + grad_numel))
            row = dict(kernel='roi_align_backward', b=b, kind=kind,
                       r=SAMPLED_ROIS, err=errs, largest=scale, same=same,
                       bound_ms=least, bound_by=by, by_kernel=by_kernel,
                       parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]])
            print(f'K12 roi_align_backward ({kind} RoIs, B {b}, '
                  f'{SAMPLED_ROIS} RoIs, d_out (7, 7, 256)): parent '
                  f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
                  f'{ms[2]:.4f} ms through the wrappers, bound {least:.4f} '
                  f'ms ({by}): parent at {least / min(ms[0], ms[3]):.1%}, '
                  f'this tree at {least / min(ms[1:3]):.1%}; max |kernel - '
                  f'plain| parent {errs[0]:.3e}, this tree {errs[1]:.3e} '
                  f'(bound 1e-5 x {scale:.3f}); the same bits in two calls: '
                  f'parent {same[0]}, this tree {same[1]}; this tree\'s '
                  f'kernels (launches, device ms a call): '
                  f'{_ms_by_kernel(by_kernel)}', flush=True)
            if max(errs) > 1e-5 * scale or not same[1]:
                raise AssertionError('a RoIAlign backward kernel differs '
                                     'from plain, or this tree\'s from '
                                     'itself')
            if sweep:
                row['sweep'] = {
                    chunk: time_ms(lambda: tree(chunk), 10)
                    for chunk in (128, 256, 512, 1024)}
                print('  sweep (chunk: ms): ' + ', '.join(
                    f'{k}: {v:.4f}' for k, v in row['sweep'].items()),
                    flush=True)
            rows.append(row)
            del d_out
            torch.cuda.empty_cache()
    return rows


def request_calls(dev):
    """The arguments of a FCAF3D request's K13, K14 and K15 calls at full
    width (2 scenes of 100,000 points, seeded weights, norms calibrated),
    as this tree's model makes them: {'kernel_map': [(jobs,), ...] (its 7
    launches), 'sparse_conv': [(feats, nbr, weights, plan), ...] (47),
    'nms3d_rotated': [(boxes, scores, valid, iou_thr, score_thr)]}."""
    from .. import zoo
    from ..engine import batch_to_device
    from ..ops import nms_rotated
    model = zoo.build_detector('fcaf3d/fcaf3d_sunrgbd.py', device=dev,
                               seed=0)
    request = batch_to_device(zoo.synth_fcaf3d_batch(2, p=100000, seed=0),
                              dev)
    calibrate_batch_norms(model, request)
    calls = {'kernel_map': [], 'sparse_conv': [], 'nms3d_rotated': []}
    hooks = [(sparse, 'kernel_tables_cuda', 'kernel_map'),
             (sparse, 'sparse_conv_cuda', 'sparse_conv'),
             (nms_rotated, 'rotated_nms_classwise_cuda', 'nms3d_rotated')]
    saved = [getattr(module, name) for module, name, _ in hooks]

    def recorder(fn, key):
        def call(*args):
            calls[key].append(args)
            return fn(*args)
        return call

    for (module, name, key), fn in zip(hooks, saved):
        setattr(module, name, recorder(fn, key))
    try:
        with torch.inference_mode():
            model.get_bboxes(model(request))
    finally:
        for (module, name, _), fn in zip(hooks, saved):
            setattr(module, name, fn)
    del model, request
    torch.cuda.empty_cache()
    return calls


def _sides(parent, change, iters, parent_only):
    """ms of parent, change, change, parent; of the parent alone (twice)
    with ``parent_only``."""
    if parent_only:
        return [time_ms(parent, iters), None, None, time_ms(parent, iters)]
    return in_turns(parent, change, iters)


def _kernels_a_call(fn):
    """(kernels a call, their device ms) by torch.profiler."""
    found = device_kernels(fn)
    return (sum(n for n, _ in found.values()),
            sum(ms for _, ms in found.values()))


def _fmt(ms):
    return 'not timed' if ms is None else f'{ms:.4f}'


def parent_table_calls(old, launches, dev):
    """The parent's calls for a request's tables, as its model made them:
    one ``neighbor_table_batched`` a conv table (the offsets made in the
    call), one more with the one-tap offsets for each stride-2 block's
    shortcut, one ``transposed_table`` an up block."""
    calls = []
    for (jobs,) in launches:
        for j in jobs:
            if j.cell:
                calls.append(lambda j=j: old.transposed_table(
                    j.query_coords, j.query_valid, j.coords, j.valid,
                    stride=j.cell // j.stride, kernel_size=j.kernel_size,
                    tensor_stride=j.stride, sorted_input=True))
                continue
            calls.append(lambda j=j: old.neighbor_table_batched(
                j.coords, j.valid, j.query_coords, j.query_valid,
                old.kernel_offsets(j.kernel_size, j.me_order, dev),
                in_stride=j.stride, sorted_input=True))
            if j.kernel_size == 2 and j.me_order:
                calls.append(lambda j=j: old.neighbor_table_batched(
                    j.coords, j.valid, j.query_coords, j.query_valid,
                    old.kernel_offsets(1, device=dev), in_stride=j.stride,
                    sorted_input=True))
    return calls


def compare_kernel_map(old, dev, parent_only):
    """K13 at the functions the model calls, a FCAF3D request's tables:
    the parent's 17 calls (``parent_table_calls``, key tables and offsets
    made in them) against this tree's 7 ``kernel_tables`` launches, in
    turns; the tables equal (the parent's one-tap tables equal tap 0 of
    the strided tables); each side's kernels a request and their device
    ms; a one-lookup launch, the least a launch takes."""
    with torch.inference_mode():
        launches = request_calls(dev)['kernel_map']
        old_calls = parent_table_calls(old, launches, dev)
        got = [t for (jobs,) in launches for t in sparse.kernel_tables(jobs)]
        want = [fn() for fn in old_calls]
        strided = [t[..., :1] for (jobs,) in launches for j, t in zip(
            jobs, sparse.kernel_tables(jobs))
            if j.kernel_size == 2 and j.me_order and not j.cell]
        if not all(torch.equal(a, b) for a, b in zip(
                got + strided, [w for w in want if w.shape[-1] != 1] +
                [w for w in want if w.shape[-1] == 1])):
            raise AssertionError('K13: the tables differ from the parent\'s')

        def parent():
            for fn in old_calls:
                fn()

        def tree():
            for (jobs,) in launches:
                sparse.kernel_tables(jobs)

        ms = _sides(parent, tree, 20, parent_only)
        sides = [('parent', parent)] + ([] if parent_only else
                                        [('this tree', tree)])
        counts = {name: _kernels_a_call(fn) for name, fn in sides}
        one = [sparse.one_lookup(launches[0][0][0])]
        one_ms = None if parent_only else time_ms(
            lambda: sparse.kernel_tables(one), 50)
        by_launch = [] if parent_only else k13_by_launch(launches)
    tables = sum(len(jobs) for (jobs,) in launches)
    print(f'K13 kernel_map, a FCAF3D request\'s tables at the model\'s '
          f'functions: parent {len(old_calls)} calls {_fmt(ms[0])} / '
          f'{_fmt(ms[3])} ms, this tree {tables} tables in {len(launches)} '
          f'launches {_fmt(ms[1])} / {_fmt(ms[2])} ms; kernels a request '
          + ', '.join(f'{name} {n:.0f} ({dms:.4f} ms on the device)'
                      for name, (n, dms) in counts.items()) +
          f'; a one-lookup launch {_fmt(one_ms)} ms', flush=True)
    return [dict(kernel='kernel_map', case='request', parent_ms=[ms[0], ms[3]],
                 ms=[ms[1], ms[2]], parent_calls=len(old_calls),
                 launches=len(launches), tables=tables,
                 kernels_a_request={k: v[0] for k, v in counts.items()},
                 device_ms={k: v[1] for k, v in counts.items()},
                 one_lookup_ms=one_ms, by_launch=by_launch)]


def k13_by_launch(launches):
    """This tree's device us of each K13 launch of the request
    (torch.profiler), with its tables: query rows x taps in a key table of
    M rows a scene."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for (jobs,) in launches:
        sparse.kernel_tables(jobs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for (jobs,) in launches:
            sparse.kernel_tables(jobs)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and
                     'kernel_map' in e.name),
                    key=lambda e: e.time_range.start)
    rows = []
    for (jobs,), e in zip(launches, events):
        tables = ', '.join(
            f'{j.query_coords.shape[1]} x {j.kernel_size ** 3}'
            f'{" (parents)" if j.cell else ""} in {j.coords.shape[1]}'
            for j in jobs)
        us = e.time_range.elapsed_us()
        print(f'  K13 launch ({tables}): {us:.1f} us on the device',
              flush=True)
        rows.append(dict(tables=tables, us=us))
    return rows


def compare_nms3d_rotated(old, dev, parent_only):
    """K15 through both wrappers as the model calls them (no IoU matrix),
    on a request's call and on spread, piled, coincident, apart and far
    boxes at its shape, in turns; this tree's masks equal the plain sweep
    fed its own IoUs, the bits in which the two sides differ printed;
    each side's kernels a call and their device ms."""
    from ..ops import nms_rotated
    from .nms_cases import rotated_nms_case
    with torch.inference_mode():
        args = request_calls(dev)['nms3d_rotated'][0]
    boxes, scores, valid, iou_thr, score_thr = args
    b, n, c = scores.shape
    cases = [('request', args)] + [
        (kind, (*(torch.from_numpy(a).to(dev) for a in rotated_nms_case(
            kind, b, n, c, seed=1)), iou_thr, score_thr))
        for kind in ('spread', 'piled', 'coincident', 'apart', 'far')]
    rows = []
    for kind, call in cases:
        bx, sc, va = call[:3]
        want = old.rotated_nms_classwise(*call)
        if not parent_only:
            iou = torch.empty((b, n, n), device=dev)
            keep = nms_rotated.rotated_nms_classwise_cuda(*call, iou=iou)
            got = nms_rotated.rotated_nms_classwise(*call)
            if not (torch.equal(got, keep) and torch.equal(
                    keep, nms_rotated.classwise_sweep(iou, sc, va, iou_thr,
                                                      score_thr))):
                raise AssertionError(f'K15 {kind}: the masks differ from '
                                     f'the plain sweep on its IoUs')
        ms = _sides(lambda: old.rotated_nms_classwise(*call),
                    lambda: nms_rotated.rotated_nms_classwise(*call), 20,
                    parent_only)
        sides = [('parent', lambda: old.rotated_nms_classwise(*call))]
        if not parent_only:
            sides.append(('this tree',
                          lambda: nms_rotated.rotated_nms_classwise(*call)))
        split = {name: device_kernels(fn) for name, fn in sides}
        differ = None if parent_only else int((got != want).sum())
        print(f'K15 nms3d_rotated ({b}, N {n}, {c} classes, {kind}): parent '
              f'{_fmt(ms[0])} / {_fmt(ms[3])} ms, this tree {_fmt(ms[1])} / '
              f'{_fmt(ms[2])} ms through the wrappers; kept '
              f'{int(want.sum())} (parent), {differ} bits differ; device '
              + '; '.join(f'{name}: ' + ', '.join(
                  f'{k} {cnt:.0f} x {t:.4f} ms' for k, (cnt, t) in
                  found.items()) for name, found in split.items()),
              flush=True)
        rows.append(dict(kernel='nms3d_rotated', case=kind,
                         parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                         bits_differ=differ,
                         device={name: {k: list(v) for k, v in found.items()}
                                 for name, found in split.items()}))
    return rows


def _k14_side(fn, calls, dtype):
    """The largest |kernel - plain| over ``calls`` relative to its bound
    (at most 1 within it)."""
    worst = 0.0
    for feats, nbr, w, *_ in calls:
        want = sparse.sparse_conv_plain(feats, nbr, w)
        err = (fn(feats, nbr, w).float() - want.float()).abs().max().item()
        worst = max(worst, err / tolerance(want, dtype))
    return worst


def compare_sparse_conv(old, dev):
    """K14 through both wrappers on a request's 47 convolutions summed and
    on the cube and scattered levels, float32 and bf16, in turns; this
    tree's plans made inside its timed call, once a table."""
    rows = []
    with torch.inference_mode():
        recorded = request_calls(dev)['sparse_conv']
        cases = [('request (47 convolutions)', [
            (f, n, w, id(p)) for f, n, w, p in recorded])]
        for kind, b, m, c, co in SPARSE_LEVELS:
            nbr, m_in = level(dev, kind, b, m)
            gen = torch.Generator(dev).manual_seed(m + c)
            cases.append((f'{kind} (B {b}, M {m}, {c} -> {co}, K 27)', [(
                torch.randn(b, m_in, c, device=dev, generator=gen), nbr,
                torch.randn(27, c, co, device=dev, generator=gen) /
                (27 * c) ** 0.5, 0)]))
        for name, calls32 in cases:
            for dtype in (torch.float32, torch.bfloat16):
                rows.append(_compare_k14(old, name, calls32, dtype))
        rows += k14_by_shape(recorded)
    return rows


def k14_by_shape(calls32):
    """This tree's device ms (torch.profiler) of the request's 47
    convolutions in float32 and bf16, summed by shape (rows, C, C_out, K,
    taps a part), with the GFLOP of the taps that exist and of those
    computed on the tiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        calls = [(f.to(dtype), n, w.to(dtype), p) for f, n, w, p in calls32]
        for args in calls:
            sparse.sparse_conv_cuda(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in calls:
                sparse.sparse_conv_cuda(*args)
            torch.cuda.synchronize()
        kernels = iter(sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and 'sparse_conv' in e.name), key=lambda e: e.time_range.start))
        by = {}
        for feats, nbr, w, plan in calls:
            b, _, c = feats.shape
            mo, k = nbr.shape[1:]
            co = w.shape[2]
            group = sparse.taps_a_part(b, mo, c, co, k, dtype)
            ms = sum(next(kernels).time_range.elapsed_us()
                     for _ in range(1 if group >= k else 2)) / 1e3
            existing, computed = conv_flops(nbr, plan, c, co)
            row = by.setdefault((mo, c, co, k, group), [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += ms
            row[2] += existing / 1e9
            row[3] += computed / 1e9
        total = sum(r[1] for r in by.values())
        print(f'K14 sparse_conv {str(dtype)[6:]}, the request\'s 47 '
              f'convolutions: {total:.4f} ms of device time', flush=True)
        for (mo, c, co, k, group), (n, ms, ex, cp) in sorted(
                by.items(), key=lambda x: -x[1][1]):
            print(f'  M {mo}, {c} -> {co}, K {k}, {group} taps a part, x{n}: '
                  f'{ms:.4f} ms, {ex:.2f} GFLOP existing / {cp:.2f} computed, '
                  f'{cp / ms:.1f} TFLOP/s computed', flush=True)
            rows.append(dict(kernel='sparse_conv_by_shape',
                             dtype=str(dtype)[6:], m_out=mo, c=c, c_out=co,
                             k=k, group=group, convs=n, ms=ms,
                             gflop_existing=ex, gflop_computed=cp))
    return rows


def _compare_k14(old, name, calls32, dtype):
    calls = [(f.to(dtype), n, w.to(dtype), t) for f, n, w, t in calls32]
    tables = {}
    for _, nbr, _, t in calls:
        tables.setdefault(t, nbr)
    existing = computed = 0.0
    for feats, nbr, w, t in calls:
        e, c = conv_flops(nbr, sparse.conv_plan(nbr), feats.shape[2],
                          w.shape[2])
        existing += e
        computed += c

    def tree():
        plans = {t: sparse.conv_plan(n) for t, n in tables.items()}
        for feats, nbr, w, t in calls:
            sparse.sparse_conv_cuda(feats, nbr, w, plans[t])

    def parent():
        for feats, nbr, w, _ in calls:
            old.sparse_conv_cuda(feats, nbr, w)

    errs = [_k14_side(old.sparse_conv_cuda, calls, dtype),
            _k14_side(sparse.sparse_conv_cuda, calls, dtype)]
    ms = in_turns(parent, tree, 5)
    row = dict(kernel='sparse_conv', case=name, dtype=str(dtype)[6:],
               err_over_bound=errs, gflop_existing=existing / 1e9,
               gflop_computed=computed / 1e9, parent_ms=[ms[0], ms[3]],
               ms=[ms[1], ms[2]])
    print(f'K14 sparse_conv {str(dtype)[6:]}, {name}: parent {ms[0]:.4f} / '
          f'{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms (its '
          f'plans included); {existing / 1e9:.3f} GFLOP of existing taps, '
          f'{computed / 1e9:.3f} computed on this tree\'s tiles; largest '
          f'|kernel - plain| over its bound: parent {errs[0]:.3f}, this '
          f'tree {errs[1]:.3f}', flush=True)
    if max(errs) > 1:
        raise AssertionError('a sparse convolution kernel differs from '
                             'plain')
    return row


def train_step_calls(dev):
    """The arguments of one FCAF3D train step's K16 and K14-on-reverse-table
    calls at full width (``configs/fcaf3d/fcaf3d_sunrgbd.py`` through
    ``zoo.build_trainer``, 8 scenes of 100,000 points, weights and scenes
    from seed 0, the GT boxes twice the size and 1.5 m down the x axis,
    where the voxels are kept): {'sparse_dweights': [(feats, nbr, g, plan),
    ...] (47), 'sparse_conv_backward': [(g, rev, weights_t, plan), ...]
    (46), 'sparse_max_pool': [((coords, valid, feats), kwargs)] (the
    stem's pool, its rows detached)}."""
    from .. import zoo
    from ..engine import batch_to_device
    model, _, _ = zoo.build_trainer('fcaf3d/fcaf3d_sunrgbd.py', device=dev,
                                    seed=0)
    batch = zoo.synth_fcaf3d_batch(b=8, p=100000, seed=0)
    batch['gt_bboxes_3d'][..., 3:6] *= 2
    batch['gt_bboxes_3d'][..., 0] -= 1.5
    batch = batch_to_device(batch, dev)
    calls = {'sparse_dweights': [], 'sparse_conv_backward': [],
             'sparse_max_pool': []}
    hooks = [(sparse, 'sparse_conv_dweights_cuda', 'sparse_dweights'),
             (sparse, 'sparse_conv_backward_cuda', 'sparse_conv_backward'),
             (sparse, 'sparse_max_pool_batched', 'sparse_max_pool')]
    saved = [getattr(module, name) for module, name, _ in hooks]

    def recorder(fn, key):
        def call(*args, **kw):
            if kw:
                calls[key].append((tuple(a.detach() for a in args), kw))
            else:
                calls[key].append(args)
            return fn(*args, **kw)
        return call

    for (module, name, key), fn in zip(hooks, saved):
        setattr(module, name, recorder(fn, key))
    try:
        model.train()
        gen = torch.Generator(dev).manual_seed(0)
        losses = model.loss(model(batch, generator=gen), batch)
        sum(losses.values()).backward()
    finally:
        for (module, name, _), fn in zip(hooks, saved):
            setattr(module, name, fn)
    torch.cuda.synchronize()
    del model, batch, losses
    torch.cuda.empty_cache()
    return calls


def _by_shape(fn, calls, marker, key):
    """Device ms (torch.profiler) of the kernels named ``marker`` that
    ``fn`` launches over ``calls`` (all of them a run), summed by ``key``
    of each call's arguments: [(key, calls, ms)], the slowest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in calls:
        fn(*args)
    torch.cuda.synchronize()
    by = {}
    for args in calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and marker in e.name)
        row = by.setdefault(key(*args), [0, 0.0])
        row[0] += 1
        row[1] += us / 1e3
    return sorted(((k, n, ms) for k, (n, ms) in by.items()),
                  key=lambda r: -r[2])


def sweep_sparse_dweights(calls32):
    """This tree's K16 device ms by shape (float32 and bf16) at grids of
    2 to 32 blocks an SM (``ops.sparse.DWEIGHTS_BLOCKS`` of the dtype, which
    sets the chunk a block takes; ``DWEIGHTS_WHOLE`` as it stands): the
    numbers behind ``dweights_chunk``."""
    rows = []
    shape = (lambda f, n, g, p: (n.shape[1], f.shape[2], g.shape[2],
                                 n.shape[2]))
    kept = sparse.DWEIGHTS_BLOCKS
    try:
        for dtype in (torch.float32, torch.bfloat16):
            calls = [(f.to(dtype), n, g.to(dtype), p)
                     for f, n, g, p in calls32]
            for per_sm in (2, 4, 8, 16, 32):
                sparse.DWEIGHTS_BLOCKS = {**kept, dtype: per_sm * SM_COUNT}
                found = _by_shape(sparse.sparse_conv_dweights_cuda, calls,
                                  'dweights', shape)
                total = sum(t for _, _, t in found)
                print(f'K16 sweep {str(dtype)[6:]}, {per_sm} blocks an SM: '
                      f'{total:.4f} ms of device time; ' + ', '.join(
                          f'{k} x{n} {t:.4f}' for k, n, t in sorted(found)),
                      flush=True)
                rows.append(dict(kernel='sparse_dweights_sweep',
                                 dtype=str(dtype)[6:], blocks_an_sm=per_sm,
                                 device_ms=total,
                                 by_shape=[[list(k), n, t]
                                           for k, n, t in found]))
    finally:
        sparse.DWEIGHTS_BLOCKS = kept
    return rows


def compare_sparse_dweights(old, dev, calls32):
    """K16 through both wrappers on a train step's 47 calls summed, float32
    and bf16, in turns; each result within 1e-5 of the plain version's
    largest, this tree's the same bits twice; device ms by shape."""
    from . import PEAK_TF32_FLOPS, bound_ms as bound
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        calls = [(f.to(dtype), n, g.to(dtype), p) for f, n, g, p in calls32]
        flops = sum(2.0 * int((n >= 0).sum()) * f.shape[2] * g.shape[2]
                    for f, n, g, _ in calls)
        nbytes = sum(f.numel() * f.element_size() + n.numel() * 4 +
                     g.numel() * g.element_size() +
                     4 * n.shape[2] * f.shape[2] * g.shape[2]
                     for f, n, g, _ in calls)
        refused = False
        try:
            old.sparse_conv_dweights_cuda(*calls[0])
        except TypeError:
            refused = True
        errs = [0.0, 0.0]
        for feats, nbr, g, plan in calls:
            want = sparse.sparse_conv_dweights_plain(feats, nbr, g)
            top = max(want.abs().max().item(), 1e-30)
            got = sparse.sparse_conv_dweights_cuda(feats, nbr, g, plan)
            if not torch.equal(got, sparse.sparse_conv_dweights_cuda(
                    feats, nbr, g, plan)):
                raise AssertionError(f'K16 {tuple(nbr.shape)}: other bits '
                                     f'on a second call')
            errs[1] = max(errs[1], (got - want).abs().max().item() / top)
            if not refused:
                errs[0] = max(errs[0], (old.sparse_conv_dweights_cuda(
                    feats, nbr, g, plan) - want).abs().max().item() / top)

        def tree():
            for args in calls:
                sparse.sparse_conv_dweights_cuda(*args)

        def parent():
            for args in calls:
                old.sparse_conv_dweights_cuda(*args)

        ms = ([None, time_ms(tree, 5), time_ms(tree, 5), None] if refused
              else in_turns(parent, tree, 5))
        least, by = bound(flops, nbytes)
        tf32, _ = bound(flops, nbytes, PEAK_TF32_FLOPS / 3)
        shape = (lambda f, n, g, p: (n.shape[1], f.shape[2], g.shape[2],
                                     n.shape[2]))
        sides = [('this tree', sparse.sparse_conv_dweights_cuda)] + (
            [] if refused else [('parent', old.sparse_conv_dweights_cuda)])
        split = {name: _by_shape(fn, calls, 'dweights', shape)
                 for name, fn in sides}
        print(f'K16 sparse_dweights {str(dtype)[6:]}, a train step\'s '
              f'{len(calls)} calls: parent {_fmt(ms[0])} / {_fmt(ms[3])} ms'
              f'{" (refuses bf16)" if refused else ""}, this tree '
              f'{ms[1]:.4f} / {ms[2]:.4f} ms; {flops / 1e9:.3f} GFLOP of '
              f'existing taps ({flops / 1e9 / ms[1]:.1f} TFLOP/s); bound '
              f'{least:.4f} ms ({by}), at 3xTF32\'s rate {tf32:.4f}; largest '
              f'|kernel - plain| of the largest: parent {errs[0]:.2e}, this '
              f'tree {errs[1]:.2e}', flush=True)
        for name, found in split.items():
            print(f'  {name}, device ms by (M_out, C, C_out, K): ' + ', '.join(
                f'{k} x{n} {t:.4f}' for k, n, t in found), flush=True)
        if max(errs) > 1e-5:
            raise AssertionError('K16 differs from plain')
        rows.append(dict(kernel='sparse_dweights', dtype=str(dtype)[6:],
                         parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                         gflop=flops / 1e9, bound_ms=least, bound_by=by,
                         tf32_bound_ms=tf32, err=errs,
                         by_shape={name: [[list(k), n, t] for k, n, t in f]
                                   for name, f in split.items()}))
    return rows


def compare_sparse_conv_backward(old, dev, calls32):
    """K14 on a train step's 46 reverse tables through both wrappers,
    float32 and bf16, in turns; each within its bound of the plain
    version; device ms by shape."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        calls = [(g.to(dtype), r, w.to(dtype), p) for g, r, w, p in calls32]
        fn_old = old.sparse_conv_backward_cuda
        try:
            fn_old(*calls[0])
        except TypeError:
            fn_old = old.sparse_conv_cuda   # the same kernel, its bf16 entry
        errs = [_k14_side(lambda f, n, w, c=c: fn_old(f, n, w, c[3]),
                          [c], dtype) for c in calls]
        errs_new = [_k14_side(lambda f, n, w, c=c:
                              sparse.sparse_conv_backward_cuda(f, n, w, c[3]),
                              [c], dtype) for c in calls]

        def tree():
            for args in calls:
                sparse.sparse_conv_backward_cuda(*args)

        def parent():
            for args in calls:
                fn_old(*args)

        ms = in_turns(parent, tree, 5)
        shape = (lambda g, r, w, p: (r.shape[1], g.shape[2], w.shape[2],
                                     r.shape[2]))
        split = {name: _by_shape(fn, calls, 'sparse_conv', shape) for name, fn
                 in (('this tree', sparse.sparse_conv_backward_cuda),
                     ('parent', fn_old))}
        print(f'K14 sparse_conv_backward {str(dtype)[6:]}, a train step\'s '
              f'{len(calls)} reverse tables: parent {ms[0]:.4f} / '
              f'{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms; '
              f'largest |kernel - plain| over its bound: parent '
              f'{max(errs):.3f}, this tree {max(errs_new):.3f}', flush=True)
        for name, found in split.items():
            print(f'  {name}, device ms by (M_in, C_out, C, K): ' + ', '.join(
                f'{k} x{n} {t:.4f}' for k, n, t in found[:8]), flush=True)
        if max(errs + errs_new) > 1:
            raise AssertionError('K14 on reverse tables differs from plain')
        rows.append(dict(kernel='sparse_conv_backward', dtype=str(dtype)[6:],
                         parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]],
                         err_over_bound=[max(errs), max(errs_new)]))
    return rows


def _device_split(fn):
    """(device ms a call of ``fn``, [(kernel, launches, ms)] slowest
    first)."""
    found = device_kernels(fn, runs=3)
    split = sorted(((k, n, ms) for k, (n, ms) in found.items()),
                   key=lambda r: -r[2])
    return sum(ms for _, _, ms in split), split


def _plain_route(module, name, plain, fn):
    """``fn`` run with ``module.name`` set to ``plain`` (this tree's plain
    route, the chain side without a parent)."""
    def call(*args, **kw):
        kept = getattr(module, name)
        setattr(module, name, plain)
        try:
            return fn(*args, **kw)
        finally:
            setattr(module, name, kept)
    return call


def _pool_calls(mod, feats, nbr, ov, g):
    """(forward, backward) of a side's K17 entries on one call, as closures
    (``mod`` its ``ops.sparse``): this tree's forward returns (output,
    mask, reverse index) and its backward reads the index and the table;
    the first K17 returned (output, mask) and read the table and M_in."""
    res = mod.sparse_max_pool_cuda(feats, nbr, ov)
    if len(res) == 3:
        _, mask, reader = res
        return (lambda: mod.sparse_max_pool_cuda(feats, nbr, ov),
                lambda: mod.sparse_max_pool_backward_cuda(g, reader, nbr,
                                                          mask))
    _, mask = res
    return (lambda: mod.sparse_max_pool_cuda(feats, nbr, ov),
            lambda: mod.sparse_max_pool_backward_cuda(g, nbr, mask,
                                                      feats.shape[1]))


def compare_sparse_max_pool(old_pool, old_sparse, dev, calls):
    """K17 on a FCAF3D train step's stem pool through both sides'
    ``sparse_max_pool_batched`` (``old_pool`` the parent's, or the chain),
    float32 and bf16 (the rows rounded), the output gradient drawn from
    seed 0: outputs and gradients the same bits; forward and forward +
    backward in turns; each side's device ms by kernel; each side's K17
    entries on the device a direction, every launch of a call (memsets
    too; ``old_sparse`` the parent's ``ops.sparse``, None for the chain),
    beside K17's bounds."""
    from . import bound_ms as bound
    from .sparse_cases import pool_bytes
    (coords, valid, feats32), kw = calls[0]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats32.to(dtype)
        shape = sparse.sparse_max_pool_batched(coords, valid, feats,
                                               **kw)[2].shape
        g = torch.randn(shape, device=dev, generator=torch.Generator(
            dev).manual_seed(0)).to(dtype)

        def forward(fn):
            return lambda: fn(coords, valid, feats, **kw)

        def both(fn):
            def run():
                x = feats.detach().requires_grad_()
                out = fn(coords, valid, x, **kw)[2]
                return out, torch.autograd.grad(out, x, g)[0]
            return run

        got, want = both(sparse.sparse_max_pool_batched)(), both(old_pool)()
        same = all(same_bits(a, b) for a, b in zip(got, want))
        fwd_ms = in_turns(forward(old_pool),
                          forward(sparse.sparse_max_pool_batched), 10)
        both_ms = in_turns(both(old_pool),
                           both(sparse.sparse_max_pool_batched), 5)
        sides = (('parent', old_pool),
                 ('this tree', sparse.sparse_max_pool_batched))
        split = {name: _device_split(both(fn)) for name, fn in sides}
        oc, ov = sparse.downsample_coords(coords, valid,
                                          2 * kw['tensor_stride'],
                                          kw['max_out'])
        nbr = sparse.kernel_tables([sparse.TableJob(
            coords, valid, oc, ov, 2, False, kw['tensor_stride'])], True)[0]
        # each entry's device ms in turns (parent, this tree, this tree,
        # parent), the parent's NaN without a parent tree
        mine = _pool_calls(sparse, feats, nbr, ov, g)
        theirs = _pool_calls(old_sparse, feats, nbr, ov, g) \
            if old_sparse is not None else (None, None)
        pool = [[_device_split(fn)[0] if fn else float('nan')
                 for fn in (old, new, new, old)]
                for old, new in zip(theirs, mine)]
        least = bound(0.0, pool_bytes(feats, nbr, ov)[0])[0]
        b_least = bound(0.0, pool_bytes(feats, nbr, ov, backward=True)[0])[0]
        print(f'K17 sparse_max_pool {str(dtype)[6:]}, a train step\'s stem '
              f'pool {tuple(feats.shape)} -> {tuple(shape)}: forward parent '
              f'{fwd_ms[0]:.4f} / {fwd_ms[3]:.4f} ms, this tree '
              f'{fwd_ms[1]:.4f} / {fwd_ms[2]:.4f}; forward + backward parent '
              f'{both_ms[0]:.4f} / {both_ms[3]:.4f}, this tree '
              f'{both_ms[1]:.4f} / {both_ms[2]:.4f}; device ms forward + '
              f'backward: parent {split["parent"][0]:.4f}, this tree '
              f'{split["this tree"][0]:.4f}; K17\'s entries on the device in '
              f'turns, forward: parent {pool[0][0]:.4f} / {pool[0][3]:.4f}, '
              f'this tree {pool[0][1]:.4f} / {pool[0][2]:.4f} (bound '
              f'{least:.6f}: {least / pool[0][1]:.1%}); backward: parent '
              f'{pool[1][0]:.4f} / {pool[1][3]:.4f}, this tree '
              f'{pool[1][1]:.4f} / {pool[1][2]:.4f} (bound {b_least:.6f}: '
              f'{b_least / pool[1][1]:.1%}); outputs and gradients the same '
              f'bits: {same}', flush=True)
        for name, (_, found) in split.items():
            print(f'  {name}, device ms by kernel: ' + ', '.join(
                f'{k} x{n:g} {ms:.4f}' for k, n, ms in found[:8]),
                flush=True)
        if not same:
            raise AssertionError('K17 differs from the parent')
        rows.append(dict(kernel='sparse_max_pool', dtype=str(dtype)[6:],
                         parent_ms=[fwd_ms[0], fwd_ms[3]],
                         ms=[fwd_ms[1], fwd_ms[2]],
                         parent_ms_with_backward=[both_ms[0], both_ms[3]],
                         ms_with_backward=[both_ms[1], both_ms[2]],
                         device_ms={k: v[0] for k, v in split.items()},
                         pool_device_ms=pool, bound_ms=[least, b_least]))
    return rows


def vote_target_inputs(dev):
    """The vote targets' call of a stage-2 step at ``VOTE_TARGETS_CALL``:
    (points (B, P, 3) of a (B, P, 4) cloud, GT boxes, valid, gt_per_seed),
    a scene without valid GT given its fake box as the heads give it."""
    from .. import zoo
    from ..engine import batch_to_device
    b, p, g, per_seed = VOTE_TARGETS_CALL
    batch = batch_to_device(zoo.synth_points_batch(b, p, g, seed=0), dev)
    valid = batch['gt_valid'].bool()
    first = torch.zeros_like(valid)
    first[:, 0] = True
    valid = torch.where(valid.any(1, keepdim=True), valid, first)
    boxes = torch.where(valid[..., None], batch['gt_bboxes_3d'], 0.0)
    return batch['points'][..., :3], boxes, valid, per_seed


def compare_vote_targets(old_targets, dev):
    """K18 through both sides' ``_vote_targets`` (``old_targets`` the
    parent's, or the plain route) on ``vote_target_inputs``: the targets
    the same bits; in turns; each side's device ms and launches by kernel;
    K18's bound (``vote_target_bound``)."""
    from ..models import target_assign
    args = vote_target_inputs(dev)
    b, p, g, per_seed = VOTE_TARGETS_CALL
    got = target_assign._vote_targets(*args)
    want = old_targets(*args)
    same = same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    ms = in_turns(lambda: old_targets(*args),
                  lambda: target_assign._vote_targets(*args), 20)
    split = {name: _device_split(lambda fn=fn: fn(*args)) for name, fn in (
        ('parent', old_targets), ('this tree', target_assign._vote_targets))}
    launches = {k: sum(n for _, n, _ in v[1]) for k, v in split.items()}
    least, by = vote_target_bound(*args)
    print(f'K18 vote_targets, a stage-2 step\'s call ({b} x {p} points, {g} '
          f'GT slots ({int(args[2].sum())} valid), {per_seed} a point): '
          f'_vote_targets parent {ms[0]:.4f} / {ms[3]:.4f} ms, this tree '
          f'{ms[1]:.4f} / {ms[2]:.4f}; device ms parent '
          f'{split["parent"][0]:.4f} in {launches["parent"]:g} launches, '
          f'this tree {split["this tree"][0]:.4f} in '
          f'{launches["this tree"]:g} (bound {least:.6f} by {by}: '
          f'{least / split["this tree"][0]:.1%}); targets the same bits: '
          f'{same}', flush=True)
    for name, (_, found) in split.items():
        print(f'  {name}, device ms by kernel: ' + ', '.join(
            f'{k} x{n:g} {t:.4f}' for k, n, t in found[:12]), flush=True)
    if not same:
        raise AssertionError('K18 differs from the parent')
    return [dict(kernel='vote_targets', parent_ms=[ms[0], ms[3]],
                 ms=[ms[1], ms[2]],
                 device_ms={k: v[0] for k, v in split.items()},
                 launches=launches, bound_ms=least, bound_by=by)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', default=None,
                    help="directory with the other commit's demf_tpu_torch")
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--only', default=','.join(KERNELS),
                    help='comma-separated kernels among ' + ', '.join(KERNELS))
    ap.add_argument('--out', default=None, help='write the rows here as JSON')
    ap.add_argument('--parent-only', action='store_true',
                    help='time the parent alone (' + ', '.join(PARENT_ONLY) +
                    ')')
    args = ap.parse_args(argv)
    only = args.only.split(',')
    if not set(only) <= set(KERNELS):
        ap.error(f'--only takes {KERNELS}')
    if args.parent_only and (args.parent is None or
                             not set(only) <= set(PARENT_ONLY)):
        ap.error(f'--parent-only takes --parent and --only among '
                 f'{PARENT_ONLY}')
    dev = cuda_device()
    (old_sampling, old_grouping, old_msda, old_mform, old_fold,
     old_boxes, old_nms2d, old_roi_align) = parent_ops(args.parent)
    rows = []
    if 'fps' in only:
        rows += compare_fps(old_sampling, dev, args.sweep)
    if 'ball_query' in only:
        rows += compare_ball_query(old_grouping, dev, args.sweep)
    if 'msda' in only:
        rows += compare_msda(old_msda, dev)
    if 'msda_backward' in only:
        rows += compare_msda_backward(old_msda, dev)
        rows += compare_msda_backward_bf16(old_msda, dev)
    if 'mform' in only:
        rows += compare_mform(old_mform, dev, args.sweep)
    if 'msda_fold' in only:
        rows += compare_msda_fold(old_fold, dev)
    if 'box_count' in only:
        old_k9 = sys.modules.get('demf_parent.ops')
        old_k9 = getattr(old_k9, 'box_point_count', None) if args.parent \
            else box_count.box_point_count_cuda
        rows += compare_box_count(old_k9 or old_boxes, dev, old_k9 is not None)
    if 'nms2d' in only:
        rows += compare_nms2d(old_nms2d, dev)
    if 'roi_align' in only:
        rows += compare_roi_align(old_roi_align, dev)
    if 'roi_align_backward' in only:
        rows += compare_roi_align_backward(old_roi_align, dev, args.sweep)
    if 'sparse_conv' in only:
        old_sparse = importlib.import_module('demf_parent.ops.sparse') \
            if args.parent else sparse
        rows += compare_sparse_conv(old_sparse, dev)
    if 'kernel_map' in only:
        old_sparse = importlib.import_module('demf_parent.ops.sparse') \
            if args.parent else sparse
        rows += compare_kernel_map(old_sparse, dev, args.parent_only)
    if 'nms3d_rotated' in only:
        from ..ops import nms_rotated
        old_nms = importlib.import_module('demf_parent.ops.nms_rotated') \
            if args.parent else nms_rotated
        rows += compare_nms3d_rotated(old_nms, dev, args.parent_only)
    if {'sparse_dweights', 'sparse_conv_backward', 'sparse_max_pool'} & \
            set(only):
        old_sparse = importlib.import_module('demf_parent.ops.sparse') \
            if args.parent else sparse
        calls = train_step_calls(dev)
        if 'sparse_max_pool' in only:
            old_pool = old_sparse.sparse_max_pool_batched if args.parent \
                else _plain_route(sparse, 'sparse_max_pool',
                                  sparse.sparse_max_pool_plain,
                                  sparse.sparse_max_pool_batched)
            rows += compare_sparse_max_pool(
            old_pool, old_sparse if args.parent else None, dev,
            calls['sparse_max_pool'])
        with torch.no_grad():
            if 'sparse_dweights' in only:
                rows += compare_sparse_dweights(
                    old_sparse, dev, calls['sparse_dweights'])
                if args.sweep:
                    rows += sweep_sparse_dweights(calls['sparse_dweights'])
            if 'sparse_conv_backward' in only:
                rows += compare_sparse_conv_backward(
                    old_sparse, dev, calls['sparse_conv_backward'])
        del calls
        torch.cuda.empty_cache()
    if 'vote_targets' in only:
        from ..models import target_assign
        from ..ops import vote_targets as vt
        old_targets = importlib.import_module(
            'demf_parent.models.target_assign')._vote_targets \
            if args.parent else _plain_route(
                target_assign, 'vote_targets', vt.vote_targets_plain,
                target_assign._vote_targets)
        rows += compare_vote_targets(old_targets, dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(device=torch.cuda.get_device_name(0), rows=rows),
                      f, indent=1)
    return rows


if __name__ == '__main__':
    main()
