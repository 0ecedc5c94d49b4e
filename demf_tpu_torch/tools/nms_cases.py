"""Seeded inputs for the aligned 3D NMS: what the tests (CPU and card) and
the smoke run hold the kernel K8, its rule in Python and the plain version
against.  Numpy only."""
from __future__ import annotations

import numpy as np

KINDS = ('random', 'clustered', 'ties', 'invalid', 'degenerate', 'one_class')


def nms_case(kind, b, n, seed=0, classes=10):
    """-> boxes (b, n, 6) f32 as (x1, y1, z1, x2, y2, z2), scores (b, n)
    f32, classes (b, n) int64, valid (b, n) bool.

    ``random``: boxes of 0.3-1.5 m over a cube of 6 m, few overlaps.
    ``clustered``: boxes of about 1 m around a center for every 64 boxes,
    most suppressed.
    ``ties``: clustered, scores on a grid of 0.1 so that many are equal.
    ``invalid``: clustered, half the boxes invalid and the last scene wholly.
    ``degenerate``: clustered, with flat, inverted and identical boxes, NaN
    and infinite coordinates and NaN scores among them.
    ``one_class``: clustered, one class.
    """
    if kind not in KINDS:
        raise ValueError(f'kind must be one of {KINDS}, got {kind!r}')
    rng = np.random.RandomState(seed)
    if kind == 'random':
        lo = rng.uniform(-3, 3, (b, n, 3))
        size = rng.uniform(0.3, 1.5, (b, n, 3))
    else:
        k = max(n // 64, 1)
        centers = rng.uniform(-2, 2, (b, k, 3))
        which = rng.randint(0, k, (b, n))
        size = rng.uniform(0.8, 1.2, (b, n, 3))
        lo = (np.take_along_axis(centers, which[..., None], 1) +
              rng.normal(0, 0.15, (b, n, 3)) - size / 2)
    boxes = np.concatenate([lo, lo + size], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    cls = rng.randint(0, classes, (b, n)).astype(np.int64)
    valid = rng.rand(b, n) < 0.9
    if kind == 'ties':
        scores = np.round(scores, 1)
    elif kind == 'invalid':
        valid = rng.rand(b, n) < 0.5
        valid[-1] = False
    elif kind == 'one_class':
        cls[:] = 3
    elif kind == 'degenerate':
        cls %= 2
        m = max(n // 8, 1)
        boxes[:, :m, 3] = boxes[:, :m, 0]                  # flat
        boxes[:, m:2 * m, 4] = boxes[:, m:2 * m, 1] - 0.5  # inverted
        boxes[:, 2 * m:3 * m] = boxes[:, 3 * m:4 * m]      # identical pairs
        cls[:, 2 * m:3 * m] = cls[:, 3 * m:4 * m]
        scores[:, 2 * m:3 * m] = scores[:, 3 * m:4 * m]
        boxes[:, 4 * m, 2] = np.nan
        boxes[:, 4 * m + 1, 5] = np.inf
        boxes[:, 4 * m + 2, 0] = -np.inf
        boxes[:, 4 * m + 3, :] = np.inf
        scores[:, 5 * m] = np.nan
        scores[:, 5 * m + 1] = np.inf
        scores[:, 5 * m + 2] = -np.inf
        valid[:, 4 * m:5 * m + 3] = True
    return boxes, scores, cls, valid
