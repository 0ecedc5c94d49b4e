"""Seeded inputs for the aligned 3D NMS, the count of points in rotated
boxes before it, the batched 2D NMS and the FCAF3D family's class-wise
rotated 3D NMS: what the tests (CPU and card) and the smoke run hold the
kernels K8, K9, K10 and K15, K8's and K10's rules in Python, K9's culling
rule and the plain versions against.  Numpy only."""
from __future__ import annotations

import numpy as np

KINDS = ('random', 'clustered', 'ties', 'invalid', 'degenerate', 'one_class')
BOX_KINDS = ('spread', 'clustered', 'faces')
ROTATED_KINDS = ('spread', 'piled', 'coincident', 'apart', 'aligned',
                 'far')
BOX_GRID_CASES = ('spread', 'clustered', 'faces', 'faces, yaw 0',
                  'faces, yaw pi/4', 'faces, yaw pi', 'cell edges',
                  'box larger than the room', 'one x', 'non-finite')


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


def _grid_faces(boxes, per_box, rng):
    """(B, N * per_box, 3) float32 points on the faces, edges and corners of
    the boxes (bottom-center), at half + 1e-6, the test's own limit."""
    b, n = boxes.shape[:2]
    box = np.repeat(boxes.astype(np.float64), per_box, 1)
    half = box[..., 3:6] * 0.5 + 1e-6
    local = rng.uniform(-1, 1, (b, n * per_box, 3)) * half
    on = rng.rand(b, n * per_box, 3) < 0.5
    on[..., 0] |= ~on.any(-1)
    sign = np.where(rng.rand(b, n * per_box, 3) < 0.5, -1.0, 1.0)
    local = np.where(on, sign * half, local)
    c, s = np.cos(box[..., 6]), np.sin(box[..., 6])
    x = local[..., 0] * c + local[..., 1] * s
    y = -local[..., 0] * s + local[..., 1] * c
    ctr = box[..., :3] + np.stack([0 * c, 0 * c, box[..., 5] * 0.5], -1)
    return (np.stack([x, y, local[..., 2]], -1) + ctr).astype(np.float32)


def _grid_boxes(rng, b, n, yaw=None, lo=-3.0, hi=3.0):
    center = np.concatenate([rng.uniform(lo, hi, (b, n, 2)),
                             rng.uniform(-1, 1, (b, n, 1))], -1)
    dims = rng.uniform(0.3, 1.5, (b, n, 3))
    yaws = (rng.uniform(-np.pi, np.pi, (b, n, 1)) if yaw is None
            else np.full((b, n, 1), yaw))
    return np.concatenate([center, dims, yaws], -1).astype(np.float32)


def box_grid_case(name, seed=0):
    """-> points (2, P, 3), boxes (2, N, 7) float32 for K9's culling rule
    (``ops/box_count.py::box_cells``), one of ``BOX_GRID_CASES``:
    ``box_count_case``'s three kinds at 300 points and 24 boxes (``spread``
    and ``clustered`` kept 1e-4 off the faces); points on the faces, edges
    and corners of boxes at yaw 0, pi/4 and pi; points and box faces on
    the edges of the grid's cells (a 16 m square, four cells a metre);
    boxes larger than the room; every point at one x; NaN and infinite
    points and boxes."""
    rng = np.random.RandomState(seed)
    if name in ('spread', 'clustered', 'faces'):
        return box_count_case(name, 2, 300, 24, seed=seed,
                              margin=None if name == 'faces' else 1e-4)
    if name.startswith('faces, yaw '):
        yaw = {'0': 0.0, 'pi/4': np.pi / 4, 'pi': np.pi}[name[11:]]
        boxes = _grid_boxes(rng, 2, 12, yaw)
        return _grid_faces(boxes, 24, rng), boxes
    if name == 'cell edges':
        # a 16 m square of four cells a metre: points and box faces on
        # quarter metres, where (x - x0) * inv is exactly a cell's edge
        pts = rng.randint(0, 65, (2, 300, 3)).astype(np.float32) / 4
        pts[:, 0, :2], pts[:, 1, :2] = 0.0, 16.0
        pts[..., 2] -= 8.0
        boxes = _grid_boxes(rng, 2, 24, 0.0)
        boxes[..., :2] = rng.randint(8, 57, (2, 24, 2)) / 4
        boxes[..., 2] = rng.randint(-8, 1, (2, 24)) / 4
        boxes[..., 3:6] = rng.randint(1, 9, (2, 24, 3)) / 2
        return pts, boxes
    if name == 'box larger than the room':
        points, boxes = box_count_case('spread', 2, 300, 24, seed=seed,
                                       margin=1e-4)
        boxes[:, :4, 3:5] = [[40.0, 25.0], [9.0, 60.0], [7.5, 7.5],
                             [1e4, 1e4]]
        boxes[:, :4, 5] = 10.0
        boxes[:, :4, 2] = -5.0
        return points, boxes
    if name == 'one x':
        points, boxes = box_count_case('clustered', 2, 300, 24, seed=seed)
        points[..., 0] = 0.25
        boxes[:, ::3, 0] = 0.25
        return points, boxes
    if name == 'non-finite':
        points, boxes = box_count_case('clustered', 2, 300, 24, seed=seed,
                                       margin=1e-4)
        points[0, ::7, 0] = np.nan
        points[0, 1::11, 1] = np.inf
        points[1, 3, 2] = np.nan
        points[1, 5, :2] = -np.inf
        boxes[0, 2, 3] = np.nan          # a size
        boxes[1, 4, 6] = np.nan          # a yaw
        boxes[1, 5, 0] = np.inf          # a centre
        boxes[1, 6, 3:6] = np.inf        # a box of no end
        boxes[0, 7, 1] = -np.inf
        return points, boxes
    raise ValueError(name)



# the 2D NMS's groups on ImVoteNet's path: the RPN's 5 levels (nms_pre 1000
# of 152x208, 76x104, 38x52, 19x26 and 10x13 positions x 3 anchors), the
# R-CNN's 10 classes of 1,000 proposals
RPN_LEVELS = (1000, 1000, 1000, 1000, 390)
# in training (``img_rpn_proposal``: nms_pre 2000) of the same image
RPN_TRAIN_LEVELS = (2000, 2000, 2000, 1482, 390)
RCNN_PROPOSALS, RCNN_CLASSES = 1000, 10


def nms2d_case(b, n, groups=1, seed=0, ties=False, degenerate=False,
               invalid=0.2, layout='random'):
    """-> boxes (b, n, 4) f32 xyxy in clusters over a 600x800 image (so that
    many overlap above the thresholds), scores (b, n) f32, groups (b, n)
    int64, valid (b, n) bool.

    ``ties``: scores on a grid of 0.25.  ``degenerate``: every 7th box of
    zero width and exact duplicates (boxes and scores) next to them.
    ``invalid``: the share of invalid entries.  ``layout``: ``random``
    groups; ``rpn``, the RPN's level groups in order (n = 4,390, all
    valid), ``rpn_train`` those of training (n = 7,872); ``rcnn``, the
    R-CNN's proposal-major classes (n = 10,000), the boxes of a proposal's
    classes close together, a score a class of a softmax over 11 and valid
    where it is over 0.1.
    """
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 700, (b, max(n // 8, 1), 2))
    pick = rng.randint(0, centers.shape[1], (b, n))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 6, (b, n, 2))
    wh = rng.uniform(8, 80, (b, n, 2))
    scores = rng.rand(b, n).astype(np.float32)
    idxs = rng.randint(0, groups, (b, n))
    valid = rng.rand(b, n) >= invalid
    if layout in ('rpn', 'rpn_train'):
        levels = RPN_LEVELS if layout == 'rpn' else RPN_TRAIN_LEVELS
        assert n == sum(levels)
        idxs = np.repeat(np.arange(len(levels)), levels)[None]
        idxs = np.repeat(idxs, b, 0)
        valid = np.ones((b, n), bool)
    elif layout == 'rcnn':
        r, k = RCNN_PROPOSALS, RCNN_CLASSES
        assert n == r * k
        c = np.repeat(c[:, :r], k, 1) + rng.normal(0, 3, (b, n, 2))
        logits = rng.normal(0, 1.5, (b, r, k + 1))
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        scores = probs[..., :k].reshape(b, n).astype(np.float32)
        idxs = np.tile(np.arange(k), r)[None].repeat(b, 0)
        valid = scores > 0.1
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    if degenerate:
        boxes[:, ::7, 2] = boxes[:, ::7, 0]
        m = boxes[:, 2::7].shape[1]
        boxes[:, 1::7][:, :m] = boxes[:, 2::7]
        scores[:, 1::7][:, :m] = scores[:, 2::7]
    return boxes, scores, idxs.astype(np.int64), valid


def rotated_nms_case(kind, b, n, classes=10, seed=0):
    """-> boxes (b, n, 7) f32 depth boxes (x, y, z_bottom, dx, dy, dz, yaw)
    of 0.3-1.5 m, class scores (b, n, classes) f32 (a fifth below 0.01,
    one NaN a scene) and valid (b, n) bool, as FCAF3D's get_bboxes hands
    them to the class-wise rotated NMS (K15).

    ``spread``: over a cube of 4 m.  ``piled``: around 4 centres, most
    overlapping.  ``coincident``: the second half copies the first.
    ``apart``: on a grid of 2.2 m (a box's BEV diagonal is at most 2.13
    m), no overlap, within 8 m of the origin as a room's boxes are.
    ``aligned``: one yaw.  ``far``: the first half 8 m apart along x, out
    to 4 n m from the origin (512 m at n 256), the second half copies of
    the first: corners hundreds of metres out carry roundings of
    R * 2**-23, and the shoelace sums cancel them into a box's IoU with
    its copy.
    """
    if kind not in ROTATED_KINDS:
        raise ValueError(f'kind must be one of {ROTATED_KINDS}, got {kind!r}')
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, n, 7), np.float32)
    boxes[..., 3:6] = rng.uniform(0.3, 1.5, (b, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    if kind == 'spread':
        boxes[..., :3] = rng.uniform(-2, 2, (b, n, 3))
    elif kind == 'piled':
        centres = rng.uniform(-2, 2, (b, 4, 3))
        which = rng.randint(0, 4, (b, n))
        boxes[..., :3] = np.take_along_axis(centres, which[..., None], 1) + \
            rng.normal(0, 0.1, (b, n, 3))
    elif kind == 'coincident':
        boxes[..., :3] = rng.uniform(-2, 2, (b, n, 3))
        boxes[:, n // 2:] = boxes[:, :n - n // 2]
    elif kind == 'apart':
        side = int(np.ceil(n ** (1 / 3)))
        cell = np.stack(np.unravel_index(np.arange(n), (side,) * 3), -1)
        boxes[..., :3] = (cell - (side - 1) / 2) * 2.2
    elif kind == 'aligned':
        boxes[..., :3] = rng.uniform(-1, 1, (b, n, 3))
        boxes[..., 6] = 0.25
    else:
        half = n - n // 2
        boxes[..., :3] = rng.uniform(-2, 2, (b, n, 3))
        boxes[:, :half, 0] = (np.arange(half) - half / 2) * 8.0
        boxes[:, half:] = boxes[:, :n - half]
    scores = rng.rand(b, n, classes).astype(np.float32)
    scores[rng.rand(b, n, classes) < 0.2] = 0.005
    scores[:, min(3, n - 1), 1 % classes] = np.nan
    valid = rng.rand(b, n) < 0.9
    return boxes, scores, valid
