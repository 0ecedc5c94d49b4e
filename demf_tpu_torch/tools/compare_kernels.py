"""K1 (FPS), K2 (ball query), K3 (MSDA forward), K4 (MSDA backward), K6
(slot fold), K7 (M-form sampler) and K9 (box count) of this tree against
the same kernels of another commit, in turns, on one card:

    mkdir -p build/parent && git archive <commit> demf_tpu_torch | \\
        tar -x -C build/parent
    python -m demf_tpu_torch.tools.compare_kernels --parent build/parent

``--parent`` is a directory that holds the other commit's
``demf_tpu_torch``.  Its ``ops`` package is loaded beside this tree's under
a name of its own and builds its kernels from its own sources, so each
side goes through its own wrapper (``furthest_point_sample_cuda``,
``ball_query_cuda``, ``msda_cuda``, ``msda_backward_cuda``,
``weighted_slot_fold_batched`` / ``slot_major_fold``,
``mform_sample_cuda``), whatever C interface lies below.  At every shape of the main paths (K7: the four
levels of ``bench_msda_matmul``, bf16 and f32) each side is timed twice, in
the order parent, this tree, this tree, parent, on tensors made beforehand;
K1's and K2's picks and K7's outputs must be equal (K7's to the plain
version's too) and K3's outputs within 1e-5 of the plain version's largest.
K4 runs at the decoder's shapes (batch 16 of 256 proposals with 2 points,
batch 4 of 300 queries with 4) and at the encoder's at batch 2 and 4 on the
same three kinds of locations as K3; its three gradients must lie within
1e-5 of the largest of the plain version's autograd on both sides.
K6 runs on one chunk of ``bench_msda_fold`` (16 slices x LP 16 x Q
22,528 rows of 128 channels) in both weight layouts ((LP, Q, 4) and
slot-major), rows in bf16 and f32; both sides must equal the plain fold.
K9 runs at a request's and an eval batch's shape (20,000 points, 512
boxes, batch 2 and 16) on spread and clustered points; a commit without
K9 stands in with the non-empty-box test its ``multiclass_nms_3d`` ran (a
Python loop of its ``core/boxes.py::points_in_boxes`` over the scenes),
and the masks ``count > 5`` must be equal.
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
every block shape and three tile sizes, and K7 at several tile and block
sizes: the numbers behind ``ops.sampling.fps_launch_shape``,
``ops.grouping.ball_query_launch_shape`` and
``ops.mform.mform_launch_shape``.  ``--only`` names the kernels to run
(``fps,ball_query,msda,msda_backward,mform,msda_fold,box_count``).  Prints its lines, writes
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
from ..ops import box_count, grouping, mform, msda, msda_fold, sampling
from ..ops._cuda import DTYPE_CODES, SMEM_PER_BLOCK
from ..ops.gather_rows import gather_rows
from . import (bench_msda_fold, bench_msda_matmul, bound_ms, cuda_device,
               encoder_sampling_locations, time_ms)
from .nms_cases import box_count_case

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


# K4: (name, scenes, queries or None for the tokens, points, noise)
MSDA_BACKWARD_CASES = (
    ('decoder', 16, 256, 2, None), ('decoder', 4, 300, 4, None),
    ('encoder, locations over the whole map', 2, None, 4, None),
    ('encoder, its own locations, noise 0.5 px', 2, None, 4, 0.5),
    ('encoder, its own locations, noise 4 px', 2, None, 4, 4.0),
    ('encoder, locations over the whole map', 4, None, 4, None),
    ('encoder, its own locations, noise 0.5 px', 4, None, 4, 0.5),
    ('encoder, its own locations, noise 4 px', 4, None, 4, 4.0))

KERNELS = ('fps', 'ball_query', 'msda', 'msda_backward', 'mform',
           'msda_fold', 'box_count')
# K9: (scenes, points, boxes) of a request and of an eval batch
BOX_COUNT_SHAPES = ((2, 20000, 512), (16, 20000, 512))


def parent_ops(parent):
    """The other commit's ``ops.sampling``, ``ops.grouping``, ``ops.msda``,
    ``ops.mform`` and ``ops.msda_fold``, loaded as the package
    ``demf_parent_ops``, and its ``core/boxes.py`` as
    ``demf_parent_boxes``; this tree's without a parent."""
    if parent is None:
        return sampling, grouping, msda, mform, msda_fold, box_ops
    path = os.path.join(parent, 'demf_tpu_torch', 'ops')
    spec = importlib.util.spec_from_file_location(
        'demf_parent_ops', os.path.join(path, '__init__.py'),
        submodule_search_locations=[path])
    package = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = package
    spec.loader.exec_module(package)
    spec = importlib.util.spec_from_file_location(
        'demf_parent_boxes',
        os.path.join(parent, 'demf_tpu_torch', 'core', 'boxes.py'))
    boxes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(boxes)
    return tuple(importlib.import_module(f'demf_parent_ops.{name}')
                 for name in ('sampling', 'grouping', 'msda', 'mform',
                              'msda_fold')) + (boxes,)


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
    """K4 at the shapes the paths launch it; the time includes the
    wrapper's zero-fill of d_value."""
    shapes = MSDA_SHAPES
    s = sum(h * w for h, w in shapes)
    gen = torch.Generator(dev).manual_seed(0)
    rows = []
    for name, b, q, p, noise in MSDA_BACKWARD_CASES:
        q = q or s
        value = torch.randn((b, s, 8, 32), generator=gen, device=dev)
        if noise is None:
            locs = torch.rand((b, q, 8, 4, p, 2), generator=gen,
                              device=dev) * 1.2 - 0.1
        else:
            locs = encoder_sampling_locations(shapes, b, 8, p, dev,
                                              jitter=noise)
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
        ms = in_turns(
            lambda: old.msda_backward_cuda(value, shapes, locs, aw, grad),
            lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad),
            10)
        rows.append(dict(kernel='msda_backward', case=name, b=b, q=q, p=p,
                         parent_err=errs[0], err=errs[1], bounds=bounds,
                         parent_ms=[ms[0], ms[3]], ms=[ms[1], ms[2]]))
        fmt = ' / '.join(['{:.3e}'] * 3)
        print(f'K4 msda_backward {name} (B {b}, Q {q}, P {p}): parent '
              f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
              f'{ms[2]:.4f} ms; max err of d_value / d_loc / d_aw vs plain: '
              f'parent {fmt.format(*errs[0])}, this tree '
              f'{fmt.format(*errs[1])} (bounds {fmt.format(*bounds)})',
              flush=True)
        if not all(e <= bd for side in errs for e, bd in zip(side, bounds)):
            raise AssertionError('an MSDA backward kernel disagrees with '
                                 'plain')
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
            ms = in_turns(before, after, 5)
            least, by = bound_ms(12 * b * p * n,
                                 4 * (points.numel() + boxes.numel() + b * n))
            row = dict(kernel='box_count', kind=kind, b=b, p=p, n=n,
                       equal=equal, parent_ms=[ms[0], ms[3]],
                       ms=[ms[1], ms[2]], bound_ms=least, bound_by=by)
            print(f'K9 box_count {kind} (B {b}, P {p}, N {n}): parent '
                  f'{"K9" if parent_has_k9 else "loop of points_in_boxes"} '
                  f'{ms[0]:.4f} / {ms[3]:.4f} ms, this tree {ms[1]:.4f} / '
                  f'{ms[2]:.4f} ms, bound {least:.6f} ms ({by}); masks equal: '
                  f'{equal}', flush=True)
            if not equal:
                raise AssertionError('the non-empty masks differ')
            rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', default=None,
                    help="directory with the other commit's demf_tpu_torch")
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--only', default=','.join(KERNELS),
                    help='comma-separated kernels among ' + ', '.join(KERNELS))
    ap.add_argument('--out', default=None, help='write the rows here as JSON')
    args = ap.parse_args(argv)
    dev = cuda_device()
    only = args.only.split(',')
    if not set(only) <= set(KERNELS):
        ap.error(f'--only takes {KERNELS}')
    (old_sampling, old_grouping, old_msda, old_mform, old_fold,
     old_boxes) = parent_ops(args.parent)
    rows = []
    if 'fps' in only:
        rows += compare_fps(old_sampling, dev, args.sweep)
    if 'ball_query' in only:
        rows += compare_ball_query(old_grouping, dev, args.sweep)
    if 'msda' in only:
        rows += compare_msda(old_msda, dev)
    if 'msda_backward' in only:
        rows += compare_msda_backward(old_msda, dev)
    if 'mform' in only:
        rows += compare_mform(old_mform, dev, args.sweep)
    if 'msda_fold' in only:
        rows += compare_msda_fold(old_fold, dev)
    if 'box_count' in only:
        old_k9 = sys.modules.get('demf_parent_ops')
        old_k9 = getattr(old_k9, 'box_point_count', None) if args.parent \
            else box_count.box_point_count_cuda
        rows += compare_box_count(old_k9 or old_boxes, dev, old_k9 is not None)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(device=torch.cuda.get_device_name(0), rows=rows),
                      f, indent=1)
    return rows


if __name__ == '__main__':
    main()
