"""Probe: the MSDA forward core at the encoder's shape, gather (K5) and
slot fold (K6) against the plain fold.

    python -m demf_tpu_torch.tools.bench_msda_fold [--batch B]

Port of ``tools/bench_msda_layer.py::main18`` (the inputs of its
``make_inputs``): BH = 8 x batch slices (batch 16: 128), each a quad plane
of N 22,336 rows of 128 bf16 channels, Q 22,528 queries x LP 16 (levels x
points) samples, idx (BH, S) and slot weights (BH, S, 4) in bf16.  The
rows of all 128 slices would take 11.8 GB, so every variant gathers and
folds 16 slices at a time.  Variants, each over all slices:

- gather only: K5, and a float32 sum of the rows (the floor);
- plain fold: K5, then the plain mul + reduce;
- K6, weights (LP, Q, 4);
- K6, weights slot-major (LP, 4, Q) in float32 (main18's layout), read
  through their strides.

On the first chunk both K6 layouts are held against the plain fold
(1e-5 of the largest output) and the fold alone is timed.  The other
variants of ``bench_msda_layer.py`` time XLA layouts and have no kernel
to port.
"""
from __future__ import annotations

import argparse

import torch

from demf_tpu_torch.ops.gather_rows import gather_rows
from demf_tpu_torch.ops.msda_fold import (slot_fold_plain, slot_major_fold,
                                          weighted_slot_fold_batched)
from demf_tpu_torch.tools import cuda_device, max_err, time_ms

N, Q, HD, NLV, NPTS = 22336, 22528, 32, 4, 4
LP = NLV * NPTS
S = Q * LP
C = 4 * HD
CHUNK = 16          # slices gathered and folded at once: 1.48 GB of rows


def make_inputs(bh, dev, seed=0):
    """plane (BH, N, C) normal, idx (BH, S) int32, w4 (BH, S, 4) uniform in
    [0, 1); bf16 plane and weights."""
    g = torch.Generator(dev).manual_seed(seed)
    plane = torch.randn(bh, N, C, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, N, (bh, S), generator=g, device=dev,
                        dtype=torch.int32)
    w4 = torch.rand(bh, S, 4, generator=g, device=dev).to(torch.bfloat16)
    return plane, idx, w4


def main(argv=None):
    """Returns dict(max_abs_err, bound, ms, plain_ms) of K6 in the
    (LP, Q, 4) layout against the plain fold on one chunk, and the same for
    the slot-major layout under ``slot_major``."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch', type=int, default=16,
                        help='scenes; BH = 8 heads x batch (default 16)')
    args = parser.parse_args(argv)
    dev = cuda_device()
    bh = 8 * args.batch
    plane, idx, w4 = make_inputs(bh, dev)
    w4 = w4.view(bh, LP, Q, 4)
    # main18's Q-minor slot-major float32 weights, the same values
    w4t = w4.permute(0, 1, 3, 2).float().contiguous()     # (BH, LP, 4, Q)
    chunks = [slice(i, min(i + CHUNK, bh)) for i in range(0, bh, CHUNK)]

    def rows_of(c):
        return gather_rows(plane[c], idx[c]).view(-1, LP, Q, C)

    variants = (
        ('gather only', lambda c: rows_of(c).sum(1, dtype=torch.float32)),
        ('plain fold', lambda c: slot_fold_plain(rows_of(c), w4[c])),
        ('K6 (LP, Q, 4)',
         lambda c: weighted_slot_fold_batched(rows_of(c), w4[c], hd=HD)),
        ('K6 slot-major',
         lambda c: slot_major_fold(rows_of(c), w4t[c])))
    samples = bh * S
    print(f'MSDA fold probe: BH {bh}, N {N}, Q {Q}, LP {LP}, C {C} bf16, '
          f'{samples} samples in chunks of {CHUNK} slices', flush=True)
    for label, fn in variants:
        t = time_ms(lambda: [fn(c) for c in chunks], 2)
        print(f'{label:<16} {t:9.4f} ms  {samples / t / 1e3:8.1f} M rows/s',
              flush=True)

    rows = rows_of(chunks[0])
    plain_ms = time_ms(lambda: slot_fold_plain(rows, w4[chunks[0]]), 3)
    want = slot_fold_plain(rows, w4[chunks[0]])
    out = {}
    for key, label, fn in (
            ('lpq4', 'K6 (LP, Q, 4)', lambda: weighted_slot_fold_batched(
                rows, w4[chunks[0]], hd=HD)),
            ('slot_major', 'K6 slot-major',
             lambda: slot_major_fold(rows, w4t[chunks[0]]))):
        err, bound = max_err(fn(), want)
        ms = time_ms(fn, 10)
        print(f'K6 msda_fold {label}, one chunk ({rows.shape[0]} slices, '
              f'{rows.shape[0] * S} samples): max_abs_err {err:.3e} (bound '
              f'{bound:.3e}); fold {ms:.4f} ms, plain fold {plain_ms:.4f} ms',
              flush=True)
        if not err <= bound:
            raise AssertionError(f'fold kernel disagrees with plain ({label})')
        out[key] = dict(max_abs_err=err, bound=bound, ms=ms,
                        plain_ms=plain_ms)
    return dict(out['lpq4'], slot_major=out['slot_major'])


if __name__ == '__main__':
    main()
