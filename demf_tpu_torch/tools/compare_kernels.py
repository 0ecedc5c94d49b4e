"""K1 (FPS) and K3 (MSDA forward) of this tree against the same kernels of
another commit, in turns, on one card:

    mkdir -p build/parent && git archive <commit> demf_tpu_torch | \\
        tar -x -C build/parent
    python -m demf_tpu_torch.tools.compare_kernels --parent build/parent

``--parent`` is a directory that holds the other commit's
``demf_tpu_torch``.  Its ``ops`` package is loaded beside this tree's under
a name of its own and builds its kernels from its own sources, so each
side goes through its own wrapper (``furthest_point_sample_cuda``,
``msda_cuda``), whatever C interface lies below.  At every shape of the
main paths each side is timed twice, in the order parent, this tree, this
tree, parent, on tensors made beforehand; K1's picks must be equal and
K3's outputs within 1e-5 of the plain version's largest.  The encoder's
shape is timed with locations drawn over the whole map and with the
encoder's own (``tools.encoder_sampling_locations``): offsets of the
module's initial grid with noise of 0.5 pixels, as a model has them before
training, and with noise of 4 pixels, which scatters a share of the
samples out of the kernel's windows as learned offsets may.  Without
``--parent`` only this tree is timed.  ``--sweep`` also times K1 of this
tree at every cluster size and block size that holds the points: the
numbers behind ``ops.sampling.fps_launch_shape``.  Prints its lines, writes
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

from ..ops import msda, sampling
from . import cuda_device, encoder_sampling_locations, time_ms

# (scenes, points, picks) of the point branch's four SA modules and the
# vote aggregation, at the training batch and the serving batch
FPS_SHAPES = [(b, n, k) for b in (16, 2) for n, k in (
    (20000, 2048), (2048, 1024), (1024, 512), (512, 256), (1024, 256))]
MSDA_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))
# (name, scenes, points a level, noise of the encoder's offsets in pixels
# or None); queries are 256 proposals or the tokens
MSDA_CASES = (('decoder', 16, 2, None), ('decoder', 2, 2, None),
              ('encoder, locations over the whole map', 2, 4, None),
              ('encoder, its own locations, noise 0.5 px', 2, 4, 0.5),
              ('encoder, its own locations, noise 4 px', 2, 4, 4.0))


def parent_ops(parent):
    """The other commit's (``ops.sampling``, ``ops.msda``), loaded as the
    package ``demf_parent_ops``; ``this tree`` twice without a parent."""
    if parent is None:
        return sampling, msda
    path = os.path.join(parent, 'demf_tpu_torch', 'ops')
    spec = importlib.util.spec_from_file_location(
        'demf_parent_ops', os.path.join(path, '__init__.py'),
        submodule_search_locations=[path])
    package = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = package
    spec.loader.exec_module(package)
    return (importlib.import_module('demf_parent_ops.sampling'),
            importlib.import_module('demf_parent_ops.msda'))


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', default=None,
                    help="directory with the other commit's demf_tpu_torch")
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--out', default=None, help='write the rows here as JSON')
    args = ap.parse_args(argv)
    dev = cuda_device()
    old_sampling, old_msda = parent_ops(args.parent)
    rows = compare_fps(old_sampling, dev, args.sweep) + compare_msda(
        old_msda, dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(device=torch.cuda.get_device_name(0), rows=rows),
                      f, indent=1)
    return rows


if __name__ == '__main__':
    main()
