"""Seeded inputs for the aligned 3D NMS and for the count of points in
rotated boxes before it: what the tests (CPU and card) and the smoke run
hold the kernels K8 and K9, K8's rule in Python and the plain versions
against.  Numpy only."""
from __future__ import annotations

import numpy as np

KINDS = ('random', 'clustered', 'ties', 'invalid', 'degenerate', 'one_class')
BOX_KINDS = ('spread', 'clustered', 'faces')


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


def box_count_case(kind, b, p, n, seed=0, margin=None):
    """-> points (b, p, 4) f32 as (x, y, z, height above the scene's lowest
    point), boxes (b, n, 7) f32 bottom-center [x, y, z, dx, dy, dz, yaw]:
    boxes of 0.3-1.5 m at any yaw over a room of 6 x 6 x 2 m.

    ``spread``: points uniform over the room, a few in each box.
    ``clustered``: points normal around box centers, a third of a box's
    size apart, many inside and many near a face.
    ``faces``: points put on the faces, edges and corners of the boxes, at
    ``0.5 * dims + 1e-6`` from the center in the box's frame (the test's
    own limit) before the rotation rounds them.
    With ``margin``, a point within ``margin`` of a face of any box (in
    float64) is drawn again until none is: tests that compare packages
    whose roundings differ use that.
    """
    if kind not in BOX_KINDS:
        raise ValueError(f'kind must be one of {BOX_KINDS}, got {kind!r}')
    rng = np.random.RandomState(seed)
    center = np.concatenate([rng.uniform(-3, 3, (b, n, 2)),
                             rng.uniform(-1, 1, (b, n, 1))], -1)
    dims = rng.uniform(0.3, 1.5, (b, n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (b, n, 1))
    boxes = np.concatenate([center, dims, yaw], -1).astype(np.float32)
    xyz = _draw_points(kind, boxes, p, rng)
    if margin is not None:
        for _ in range(100):
            near = ~_off_faces(xyz, boxes, margin)
            if not near.any():
                break
            xyz[near] = _draw_points(kind, boxes, p, rng)[near]
        else:
            raise RuntimeError('points stay near a face')
    height = xyz[..., 2:] - xyz[..., 2:].min(1, keepdims=True) if p else \
        xyz[..., 2:]
    return np.concatenate([xyz, height], -1).astype(np.float32), boxes


def _draw_points(kind, boxes, p, rng):
    """(b, p, 3) float32 points of ``kind`` for these boxes."""
    b, n = boxes.shape[:2]
    if kind == 'spread' or n == 0:
        return np.concatenate([rng.uniform(-3.5, 3.5, (b, p, 2)),
                               rng.uniform(-1.5, 2.5, (b, p, 1))],
                              -1).astype(np.float32)
    which = rng.randint(0, n, (b, p))
    box = np.take_along_axis(boxes.astype(np.float64), which[..., None], 1)
    half = box[..., 3:6] * 0.5
    if kind == 'clustered':
        local = rng.normal(0, 1 / 3, (b, p, 3)) * box[..., 3:6]
    else:
        # each coordinate on a face (+-limit) or inside, at least one on
        local = rng.uniform(-1, 1, (b, p, 3)) * half
        on = rng.rand(b, p, 3) < 0.5
        on[..., 0] |= ~on.any(-1)
        sign = np.where(rng.rand(b, p, 3) < 0.5, -1.0, 1.0)
        local = np.where(on, sign * (half + 1e-6), local)
    c, s = np.cos(box[..., 6]), np.sin(box[..., 6])
    # the box frame back to the room: the inverse of points_in_boxes' turn
    x = local[..., 0] * c + local[..., 1] * s
    y = -local[..., 0] * s + local[..., 1] * c
    ctr = box[..., :3] + np.stack([0 * c, 0 * c, half[..., 2]], -1)
    return (np.stack([x, y, local[..., 2]], -1) + ctr).astype(np.float32)


def _off_faces(xyz, boxes, margin):
    """(b, p) bool: the point is at least ``margin`` from every face plane
    of every box of its scene, in the box's frame, in float64."""
    bx = boxes.astype(np.float64)[:, None]                  # (b, 1, n, 7)
    shift = xyz.astype(np.float64)[:, :, None] - bx[..., :3]
    shift[..., 2] -= bx[..., 5] * 0.5
    c, s = np.cos(bx[..., 6]), np.sin(bx[..., 6])
    local = np.stack([shift[..., 0] * c - shift[..., 1] * s,
                      shift[..., 0] * s + shift[..., 1] * c,
                      shift[..., 2]], -1)
    gap = np.abs(np.abs(local) - bx[..., 3:6] * 0.5)
    return (gap >= margin).all(-1).all(-1)
