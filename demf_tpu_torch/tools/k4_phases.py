"""Where K4 (MSDA backward) spends its time at the encoder's shape:

    python -m demf_tpu_torch.tools.k4_phases [--batch 2]

Where no kernel profiler is at hand: this builds ``csrc/msda_backward.cu``
with one phase after another taken out (``-DK4_SKIP=n``: a loop bound that
is never true at run time, so the compiler keeps the rest as it is) and
times each on the same inputs: the encoder's own locations with
noise of 0.5 and of 4 pixels (``tools.encoder_sampling_locations``).  The
differences between neighbouring lines are the phases' times.  Only the
first line computes the right result; the copies go to
``build/kernels/k4_phases`` and are used nowhere else.  Prints its lines and
returns the rows.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from ..ops import _cuda, msda
from . import cuda_device, encoder_sampling_locations, time_ms
from .compare_kernels import MSDA_SHAPES

# what is left with -DK4_SKIP=n (csrc/msda_backward.cu)
LEFT = (
    'the whole kernel',
    'without the row-major phase (no list is walked, d_value stays 0)',
    'and without linking the entries',
    'and without the sample-major phase: copies, barriers, the query-major '
    'kernel, the zero-fill',
    'the query-major kernel and the zero-fill alone',
)


def build_variants():
    """-> [(what is left, path of its shared library)]"""
    out_dir = os.path.join(_cuda.BUILD_DIR, 'k4_phases')
    os.makedirs(out_dir, exist_ok=True)
    source = os.path.join(_cuda.CSRC_DIR, 'msda_backward.cu')
    built, procs = [], []
    for skip, what in enumerate(LEFT):
        path = os.path.join(out_dir, f'skip{skip}.so')
        procs.append(subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f'-DK4_SKIP={skip}', '-shared',
             '-o', path, source], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        built.append((what, path))
    for (what, _), proc in zip(built, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on "{what}":\n{err[-3000:]}')
    return built


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=2)
    args = ap.parse_args(argv)
    dev = cuda_device()
    shapes, b, heads, hd, points = MSDA_SHAPES, args.batch, 8, 32, 4
    s = sum(h * w for h, w in shapes)
    gen = torch.Generator(dev).manual_seed(0)
    value = torch.randn((b, s, heads, hd), generator=gen, device=dev)
    aw = torch.rand((b, s, heads, len(shapes) * points), generator=gen,
                    device=dev)
    aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, s, heads, len(shapes),
                                                 points)
    grad = torch.randn((b, s, heads * hd), generator=gen, device=dev)
    level_info, tile_info, tiles, direct_from, max_tile = msda._tables(
        shapes, hd, True, dev)
    d_value = torch.empty_like(value)
    d_aw = torch.empty_like(aw)
    rows = []
    variants = build_variants()
    for noise in (0.5, 4.0):
        locs = encoder_sampling_locations(shapes, b, heads, points, dev,
                                          jitter=noise)
        d_locs = torch.empty_like(locs)
        for what, path in variants:
            fn = ctypes.CDLL(path).demf_msda_backward
            fn.argtypes = msda.MSDA_BACKWARD_KERNEL.argtypes + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run():
                d_value.zero_()
                err = fn(value.data_ptr(), level_info.data_ptr(),
                         tile_info.data_ptr(), locs.data_ptr(),
                         aw.data_ptr(), grad.data_ptr(), d_value.data_ptr(),
                         d_locs.data_ptr(), d_aw.data_ptr(), b, s, s, heads,
                         hd, len(shapes), points, tiles, direct_from,
                         max_tile, _cuda.current_stream_handle())
                if err:
                    raise RuntimeError(f'CUDA error {err} at launch')

            ms = time_ms(run, 10)
            rows.append(dict(noise=noise, left=what, ms=ms))
            print(f'K4 at (B {b}, Q {s}, P {points}), noise {noise} px, '
                  f'{what}: {ms:.4f} ms', flush=True)
    return rows


if __name__ == '__main__':
    main()
