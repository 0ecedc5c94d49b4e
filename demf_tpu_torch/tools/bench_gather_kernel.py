"""Probe: kernel K5 (row gather) against the plain gather.

    python -m demf_tpu_torch.tools.bench_gather_kernel [--small]

Port of ``tools/bench_gather_kernel.py::main``.  Full shape: the encoder's
level-concatenated quad plane at batch 16 x 8 heads (BH 128, N 22,336
rows of 128 bf16 channels, 732 MB) and S 90,112 samples a slice (2.95 GB
of rows out); ``--small``: BH 4, N 1,024, S 8,192.  Correctness first: K5
equals the plain gather bit for bit at N 999 (a plane that is not a
multiple of 8 or 16 rows) in bf16 and f32, and at the probe's shape; each
case is then timed against the plain gather: ms and M rows/s.
"""
from __future__ import annotations

import argparse

import torch

from demf_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
from demf_tpu_torch.tools import cuda_device, time_ms

FULL = dict(bh=128, n=22336, s=90112, c=128)
SMALL = dict(bh=4, n=1024, s=8192, c=128)
UNALIGNED_N = 999


def make_inputs(bh, n, s, c, dtype, dev, seed=0):
    """plane (BH, N, C) normal, idx (BH, S) int32 uniform in [0, N)."""
    g = torch.Generator(dev).manual_seed(seed)
    plane = torch.randn(bh, n, c, generator=g, device=dev).to(dtype)
    idx = torch.randint(0, n, (bh, s), generator=g, device=dev,
                        dtype=torch.int32)
    return plane, idx


def run_case(plane, idx, label, iters):
    """K5 against the plain gather, bit for bit, then both timed; returns
    dict(max_abs_err, ms, plain_ms)."""
    got = gather_rows(plane, idx)
    want = gather_rows_plain(plane, idx)
    same = torch.equal(got, want)
    err = 0.0 if same else (got.float() - want.float()).abs().max().item()
    del got, want
    plain_ms = time_ms(lambda: gather_rows_plain(plane, idx), iters)
    ms = time_ms(lambda: gather_rows(plane, idx), 2 * iters)
    rows = idx.numel()
    print(f'K5 gather_rows {label} {tuple(plane.shape)} {plane.dtype} S '
          f'{idx.shape[1]}: max_abs_err {err:.3e} (bound 0: bit-equal); '
          f'kernel {ms:.4f} ms ({rows / ms / 1e3:.1f} M rows/s), plain '
          f'{plain_ms:.4f} ms ({rows / plain_ms / 1e3:.1f} M rows/s)',
          flush=True)
    if not same:
        raise AssertionError(f'gather kernel differs from plain ({label})')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def main(argv=None):
    """Returns dict(max_abs_err, ms, plain_ms) at the probe's shape."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--small', action='store_true',
                        help='BH 4, N 1,024, S 8,192')
    args = parser.parse_args(argv)
    dev = cuda_device()
    shape = SMALL if args.small else FULL
    for dtype in (torch.bfloat16, torch.float32):
        plane, idx = make_inputs(shape['bh'], UNALIGNED_N, 8192, shape['c'],
                                 dtype, dev, seed=1)
        run_case(plane, idx, f'N {UNALIGNED_N}', 3)
    plane, idx = make_inputs(**shape, dtype=torch.bfloat16, dev=dev)
    return run_case(plane, idx, 'probe shape', 5)


if __name__ == '__main__':
    main()
