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
   version's autograd at the decoder's training shape and at the
   encoder's shape; then the NMS (plain torch, no kernel yet) timed alone
   at a request's shape beside its bound;
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
   width, seeded random weights) answers 3 requests of batch 2 at 20,000
   points and an 800x1344 image through
   ``engine.evaluation.make_eval_step``; every request must launch each
   kernel a fixed number of times; one more request runs under
   torch.profiler and prints the device time of K1-K3 on the model's own
   inputs and the device's busy share;
7. training reference: the full-width detector on a small input, dropout
   off, one forward + loss + backward with the kernels against one with
   the plain versions: losses within 1e-4 relative, each gradient within
   1e-3 of that tensor's largest;
8. training path: the stage-2 step at full width, batch 16 x 20,000 points
   and 800x1344 images, seeded weights: the frozen image branch fills the
   feature cache once, then 3 steps through ``engine.trainer``, each with
   finite losses and gradient norm and a fixed number of launches of each
   kernel; the image branch must stay unchanged and every other parameter
   move.

The line before the last is the kernel table as JSON (K1-K4: launches
counted in the training path, times and bound at its shape, each kernel's
first row above; K5-K7: launches counted in the probes phase, times and
bound of K5 at the gather probe's shape, K6 in the (LP, Q, 4) layout on
one chunk, K7 at the finest level; ``library_ms`` is the one PyTorch call
that computes the kernel's function (K5 an indexing call, K6 an einsum, K7
an ``embedding_bag`` with weights) and null where there is none: FPS, the
exact ball query, MSDA and its backward); the
last line is ``{"ok": true, "device": {...}}``.
Float32 throughout: TF32 is switched off for matmuls and cuDNN
convolutions.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# requests per run and what each must launch (4 SA + 1 vote aggregation for
# FPS and ball query; 6 encoder layers + 1 decoder layer for MSDA)
REQUESTS = (0, 1, 2)
LAUNCHES_PER_REQUEST = {'fps': 5, 'ball_query': 5, 'msda': 7,
                        'msda_backward': 0, 'gather_rows': 0, 'msda_fold': 0,
                        'mform_sample': 0}
# train steps per run and what each must launch (the image branch runs
# once, before, to fill the feature cache)
TRAIN_STEPS = 3
TRAIN_BATCH = dict(b=16, p=20000, g=64, hw=(800, 1344))
LAUNCHES_PER_STEP = {'fps': 5, 'ball_query': 5, 'msda': 1,
                     'msda_backward': 1, 'gather_rows': 0, 'msda_fold': 0,
                     'mform_sample': 0}
# the probes' kernels: their launches are counted over the probes phase
PROBE_KERNELS = ('gather_rows', 'msda_fold', 'mform_sample')
REPLACES = {
    'fps': 'demf_tpu/ops/pallas/fps.py:60',
    'ball_query': 'demf_tpu/ops/grouping.py:38',
    'msda': 'demf_tpu/ops/msda.py:975',
    'msda_backward': 'demf_tpu/ops/msda.py:572',
    'gather_rows': 'demf_tpu/ops/pallas/gather_rows.py:81',
    'msda_fold': 'demf_tpu/ops/pallas/msda_fold.py:113',
    'mform_sample': 'tools/bench_msda_matmul.py:73',
}
SOURCES = {'fps': 'demf_tpu_torch/csrc/fps.cu',
           'ball_query': 'demf_tpu_torch/csrc/ball_query.cu',
           'msda': 'demf_tpu_torch/csrc/msda.cu',
           'msda_backward': 'demf_tpu_torch/csrc/msda_backward.cu',
           'gather_rows': 'demf_tpu_torch/csrc/gather_rows.cu',
           'msda_fold': 'demf_tpu_torch/csrc/msda_fold.cu',
           'mform_sample': 'demf_tpu_torch/csrc/mform_sample.cu'}
MSDA_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))


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


def time_nms(dev, rng):
    """``ops.nms.aligned_3d_nms`` (plain torch on the device, no kernel
    yet) alone, at a request's shape: 2 scenes of 512 boxes in 10 classes.
    Its bound counts the N^2 pair IoUs (22 operations a pair); the greedy
    sweep's N dependent steps are what a kernel would have to beat."""
    from demf_tpu_torch.ops.nms import aligned_3d_nms
    from demf_tpu_torch.tools import bound_ms, time_ms
    b, n = 2, 512
    lo = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.5, (b, n, 3)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([lo, lo + size], -1)).to(dev)
    scores = torch.from_numpy(rng.rand(b, n).astype(np.float32)).to(dev)
    classes = torch.from_numpy(rng.randint(0, 10, (b, n))).to(dev)
    keep = aligned_3d_nms(boxes, scores, classes, 0.25)
    ms = time_ms(lambda: aligned_3d_nms(boxes, scores, classes, 0.25), 3)
    least, by = bound_ms(22 * b * n * n,
                         b * n * (24 + 4 + 8) + keep.numel())
    print(f'NMS aligned_3d_nms ({b}, N {n}, 10 classes; plain torch, no '
          f'kernel): kept {int(keep.sum())} of {b * n}, {ms:.4f} ms, bound '
          f'{least:.6f} ms ({by})')


def msda_bytes(shapes, value, locs, aw, backward=False):
    """What MSDA must move for these inputs: the value rows its samples
    touch, locations, weights and the output; the backward also reads the
    output's gradient and writes all three gradients (d_value in full)."""
    from demf_tpu_torch.tools import msda_rows_touched
    hd = value.shape[-1]
    out = value.shape[0] * locs.shape[1] * value.shape[2] * hd
    moved = msda_rows_touched(shapes, locs) * hd + locs.numel() + \
        aw.numel() + out
    if backward:
        moved += value.numel() + locs.numel() + aw.numel()
    return 4 * moved


def check_msda(dev, rng):
    from demf_tpu_torch.ops import msda
    from demf_tpu_torch.tools import (bound_ms, encoder_sampling_locations,
                                      time_ms)
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    rows = []
    for b, q, p, own in ((16, 256, 2, False), (2, 256, 2, False),
                         (2, s, 4, False), (2, s, 4, True)):
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
    return rows[0]


def check_msda_backward(dev, rng):
    """K4 against the plain version's autograd, at the decoder's training
    shape (batch 16, Q 256, P 2) and at the encoder's (batch 2, Q 22,323,
    P 4).  The kernel time includes zeroing d_value."""
    from demf_tpu_torch.ops import msda
    from demf_tpu_torch.tools import bound_ms, time_ms
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    rows = []
    for b, q, p in ((16, 256, 2), (2, s, 4)):
        value = torch.from_numpy(
            rng.randn(b, s, 8, 32).astype(np.float32)).to(dev)
        locs = torch.from_numpy(rng.uniform(
            -0.1, 1.1, (b, q, 8, 4, p, 2)).astype(np.float32)).to(dev)
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

        errs, bounds = [], []
        for g, w in zip(kernel(), plain()):
            errs.append((g - w).abs().max().item())
            bounds.append(1e-5 * w.abs().max().item())
        ms = time_ms(kernel, 10)
        plain_ms = time_ms(plain, 3)
        # a sample and channel: 4 corners, each an add into d_value and a
        # product into d_aw and into both halves of d_loc
        least, by = bound_ms(
            30 * aw.numel() * 32,
            msda_bytes(shapes, value, locs, aw, backward=True))
        print(f'K4 msda_backward ({b}, Q {q}, heads 8, hd 32, L 4, P {p}, '
              f'sum_HW {s}): max_abs_err d_value / d_loc / d_aw '
              f'{errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bounds '
              f'{bounds[0]:.3e} / {bounds[1]:.3e} / {bounds[2]:.3e}), '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, least '
              f'{least:.4f} ms ({by})')
        if not all(e <= bd for e, bd in zip(errs, bounds)):
            raise AssertionError('MSDA backward kernel disagrees with plain')
        rows.append(kernel_row(max(errs), ms, plain_ms, least, by))
    return rows[0]


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
    """Route the model's FPS and MSDA calls to their plain versions (the
    kernel ball query stays: its picks are checked on their own above)."""

    def __enter__(self):
        from demf_tpu_torch.models import pointnet2, transformer, vote_head
        from demf_tpu_torch.ops import msda, sampling
        fps = sampling.furthest_point_sample_plain
        self.saved = [(pointnet2, 'furthest_point_sample'),
                      (vote_head, 'furthest_point_sample'),
                      (transformer, 'multi_scale_deformable_attention')]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.saved]
        pointnet2.furthest_point_sample = fps
        vote_head.furthest_point_sample = fps
        transformer.multi_scale_deformable_attention = msda.msda_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


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


def profile_request(eval_step, batch):
    """One more request under torch.profiler: the device time of the
    port's kernels on the model's own inputs, and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eval_step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eval_step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ours = []
    for marker in ('fps_kernel', 'ball_query_kernel', 'msda_forward_kernel'):
        hits = [e for e in events if marker in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        ours.append(f'{marker} {ms:.3f} ms in '
                    f'{sum(e.count for e in hits)} launches')
    print(f'profiled request: untraced {wall_ms:.3f} ms (host clock), device '
          f'kernels {busy_ms:.3f} ms, busy share {busy_ms / wall_ms:.1%}; '
          + '; '.join(ours))


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
    """The stage-2 step at full width; returns the launches of the steps."""
    from demf_tpu_torch import zoo
    from demf_tpu_torch.engine import batch_to_device, compute_image_features
    t0 = time.perf_counter()
    model, _, step = zoo.build_trainer('demf/demf_votenet.py', dev, seed=0)
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
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {n: k.launches - start[n] for n, k in kernels.items()}
        if launched != LAUNCHES_PER_STEP:
            raise AssertionError(f'step {i} launched {launched}, expected '
                                 f'{LAUNCHES_PER_STEP}')
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        if bad:
            raise AssertionError(f'step {i}: non-finite {bad}')
        terms = ', '.join(f'{k} {v.item():.5f}' for k, v in metrics.items())
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
    return launches


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
                'msda_backward': check_msda_backward(dev, rng)}
    kernels = ops.kernels()
    time_nms(dev, rng)
    probed, probe_launches = run_probes(dev, rng, kernels)
    measured.update(probed)

    t0 = time.perf_counter()
    model = zoo.build_detector('demf/demf_votenet.py', device=dev, seed=0)
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
    del model, eval_step
    check_train_reference(dev)
    launches = run_training_path(dev, kernels)
    launches.update(probe_launches)

    table = [dict(name=n, route='cuda', source=SOURCES[n],
                  replaces=REPLACES[n], launches=launches[n], **measured[n])
             for n in kernels]
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
