"""Probe: kernel K7 (M-form MSDA sampling) against its plain version.

    python -m demf_tpu_torch.tools.bench_msda_matmul

Port of ``tools/bench_msda_matmul.py::run_level`` / ``main``: for each of
the encoder's four levels (planes of 16,896 / 4,608 / 1,536 / 512 rows:
100x168, 50x84, 25x42 and 13x21 padded), BH 128 (batch 16 x 8 heads), Q
22,528 queries (22,323 padded), head_dim 32, 16 slots (4 points x 4
bilinear corners), bf16 plane and weights.  K7 is held against the plain
version (the same float32 sums in the same order) within 1e-5 of the
largest output, then both are timed: ms and M rows/s.
"""
from __future__ import annotations

import argparse

import torch

from demf_tpu_torch.ops.mform import mform_sample, mform_sample_plain
from demf_tpu_torch.tools import cuda_device, max_err, time_ms

BH, Q, HD, SLOTS = 128, 22528, 32, 16
LEVELS = ((16896, 'lvl0'), (4608, 'lvl1'), (1536, 'lvl2'), (512, 'lvl3'))


def make_inputs(bh, n, q, hd, nslots, dev, seed=0):
    """plane (BH, N, hd) normal, idx16 (BH, K, Q, 1) int32 uniform in
    [0, N), w16 (BH, K, Q, 1) uniform in [0, 1); bf16 plane and weights."""
    g = torch.Generator(dev).manual_seed(seed)
    plane = torch.randn(bh, n, hd, generator=g, device=dev).to(
        torch.bfloat16)
    idx16 = torch.randint(0, n, (bh, nslots, q, 1), generator=g, device=dev,
                          dtype=torch.int32)
    w16 = torch.rand(bh, nslots, q, 1, generator=g, device=dev).to(
        torch.bfloat16)
    return plane, idx16, w16


def run_level(n, label, dev, bh=BH, q=Q, hd=HD, nslots=SLOTS):
    """Returns dict(max_abs_err, bound, ms, plain_ms) of one level."""
    plane, idx16, w16 = make_inputs(bh, n, q, hd, nslots, dev)
    err, bound = max_err(mform_sample(plane, idx16, w16),
                         mform_sample_plain(plane, idx16, w16))
    plain_ms = time_ms(lambda: mform_sample_plain(plane, idx16, w16), 3)
    ms = time_ms(lambda: mform_sample(plane, idx16, w16), 10)
    rows = bh * q * nslots
    print(f'K7 mform_sample {label} N={n:6d}: max_abs_err {err:.3e} (bound '
          f'{bound:.3e}); kernel {ms:.4f} ms ({rows / ms / 1e3:.1f} M rows/s)'
          f', plain {plain_ms:.4f} ms ({rows / plain_ms / 1e3:.1f} M rows/s)',
          flush=True)
    if not err <= bound:
        raise AssertionError(f'M-form kernel disagrees with plain ({label})')
    return dict(max_abs_err=err, bound=bound, ms=ms, plain_ms=plain_ms)


def main(argv=None):
    """Returns level label -> dict(max_abs_err, bound, ms, plain_ms)."""
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)
    dev = cuda_device()
    return {label: run_level(n, label, dev) for n, label in LEVELS}


if __name__ == '__main__':
    main()
