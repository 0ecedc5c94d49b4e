"""Points in rotated 3D boxes, counted: CUDA kernel K9 and its plain
version.

``count[b, n]`` is the number of points of scene ``b`` inside box ``n``:
the sum over the points of ``core/boxes.py::points_in_boxes``, for a whole
batch.  Port of the non-empty-box test's count in
``demf_tpu/models/vote_head.py::multiclass_nms_3d`` (``jnp.sum(
points_in_boxes(pts[:, :3], bottom), 0)``, ``points_in_boxes`` at
``demf_tpu/core/boxes.py:105``, vmapped over the batch).

A CUDA tensor launches K9 (``csrc/box_count.cu``): the yaw's cosine and
sine by torch, then two kernels for the whole batch, four launches a call.
Its first kernel bins each scene's points into a grid over their xy
extent, its second tests each box against the points of the cells its
bounding circle covers (``box_cells`` is that grid and cover in plain
PyTorch; ``box_point_count_grid`` counts with it).  A CPU tensor takes the
plain version, which tests every point against every box a chunk at a
time, so that it never holds a (P, N) temporary for the whole batch.  All
take the per-box terms of ``box_terms`` (the kernel computes them itself
with the same roundings, but cos and sin) and test in the same order with
the same roundings, so their counts are equal; a NaN point or box counts
nothing on any of them.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel

BOX_COUNT_KERNEL = CudaKernel(
    'demf_box_count', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 +
    [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int])

# the plain version tests about this many (point, box) pairs at a time
PLAIN_PAIRS = 1 << 24
# csrc/box_count.cu: cells on each axis of a scene's grid, the margins of
# a box's bounding circle (of its radius; of the magnitudes of its centre
# and the grid's corner), the most scenes (the count kernel's second grid
# axis) and points a scene (8 bin blocks, each placing 65,535 in 16 bits)
GRID = 64
RADIUS_MARGIN = 1.0 + 2.0 ** -10
MAGNITUDE_MARGIN = 2.0 ** -14
MAX_SCENES = 65535
MAX_POINTS = 8 * 65535


def box_terms(boxes, eps=1e-6):
    """(B, N, 7) bottom-center boxes -> (B, N, 8) float terms of the test:
    the gravity center, cos and sin of the yaw, and ``0.5 * dims + eps``,
    with the roundings of ``core/boxes.py::points_in_boxes`` (the center's
    z is ``z + dz * 0.5`` as in ``gravity_center``), in six launches on the
    card."""
    half = boxes[..., 3:6] * 0.5
    yaw = boxes[..., 6:7]
    return torch.cat([boxes[..., :2], boxes[..., 2:3] + half[..., 2:3],
                      torch.cos(yaw), torch.sin(yaw), half + eps], -1)


def box_point_count(points, boxes, eps=1e-6):
    """points (B, P, >=3) float32 of any strides, boxes (B, N, 7) float32
    bottom-center -> (B, N) int32 counts of the points inside each box.  A
    CPU tensor takes the plain version; a CUDA tensor launches K9 or
    raises."""
    if points.device.type == 'cpu':
        return box_point_count_plain(points, boxes, eps)
    return box_point_count_cuda(points, boxes, eps)


def box_point_count_plain(points, boxes, eps=1e-6, chunk=None):
    """The test of ``points_in_boxes`` on ``chunk`` points of every scene
    at a time (by default as many as make ``PLAIN_PAIRS`` pairs), summed
    over the points."""
    b, p = points.shape[:2]
    n = boxes.shape[1]
    count = torch.zeros((b, n), dtype=torch.int32, device=boxes.device)
    if chunk is None:
        chunk = max(1, PLAIN_PAIRS // max(1, b * n))
    terms = box_terms(boxes, eps)[:, None]                 # (B, 1, N, 8)
    center, c, s, half = (terms[..., :3], terms[..., 3], terms[..., 4],
                          terms[..., 5:])
    for start in range(0, p, chunk):
        shift = points[:, start:start + chunk, None, :3] - center
        lx = shift[..., 0] * c - shift[..., 1] * s
        ly = shift[..., 0] * s + shift[..., 1] * c
        inside = ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1]) &
                  (shift[..., 2].abs() <= half[..., 2]))
        count += inside.sum(1, dtype=torch.int32)
    return count


def _cell_of(v, v0, inv):
    """floor((v - v0) * inv) in float32, held in [0, GRID - 1] (a NaN falls
    to 0), as ``csrc/box_count.cu::cell_of``."""
    f = torch.floor((v - v0) * inv)
    return torch.nan_to_num(f, nan=0.0).clamp(0, GRID - 1).long()


def box_cells(points, boxes, eps=1e-6):
    """K9's grid and cover for one scene: points (P, >=3), boxes (N, 7) ->
    (cell (P,) int64 of each point, row-major in a GRID x GRID grid over
    the xy extent of the finite points, GRID ** 2 for a point with a
    non-finite x or y; cover (N, 4) int64 of each box's first and last
    column and row, the cells its bounding circle ``sqrt(hx^2 + hy^2)``
    reaches, widened by ``RADIUS_MARGIN`` and ``MAGNITUDE_MARGIN``; every
    cell for a box with a non-finite term).  Every point that the test of
    ``points_in_boxes`` counts in a box lies in a cell of its cover or has
    a non-finite x or y."""
    x, y = points[:, 0], points[:, 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    grid = []
    for v in (x, y):
        v = v[finite]
        lo, hi = (v.min(), v.max()) if v.numel() else (v.new_tensor(0.0),) * 2
        inv = (v.new_tensor(float(GRID)) / (hi - lo) if hi > lo
               else v.new_tensor(0.0))
        grid.append((lo, hi, inv))
    (x0, x1, inv_x), (y0, y1, inv_y) = grid
    magnitude = torch.stack([x0.abs(), x1.abs(), y0.abs(), y1.abs()]).max()
    cell = _cell_of(y, y0, inv_y) * GRID + _cell_of(x, x0, inv_x)
    cell = torch.where(finite, cell, GRID * GRID)
    terms = box_terms(boxes, eps)
    cx, cy, c, s, hx, hy = (terms[:, i] for i in (0, 1, 3, 4, 5, 6))
    r = (torch.sqrt(hx * hx + hy * hy) * RADIUS_MARGIN +
         (magnitude + cx.abs() + cy.abs()) * MAGNITUDE_MARGIN)
    cover = torch.stack([_cell_of(cx - r, x0, inv_x),
                         _cell_of(cx + r, x0, inv_x),
                         _cell_of(cy - r, y0, inv_y),
                         _cell_of(cy + r, y0, inv_y)], -1)
    ok = torch.stack([cx, cy, hx, hy, c, s], -1).isfinite().all(-1)
    every = cover.new_tensor([0, GRID - 1, 0, GRID - 1])
    return cell, torch.where(ok[:, None], cover, every)


def box_point_count_grid(points, boxes, eps=1e-6):
    """The count as K9 takes it: each box tests only the points of its
    cover's cells and those with a non-finite x or y (``box_cells``), with
    the test and roundings of ``box_point_count_plain``.  (B, P, >=3),
    (B, N, 7) -> (B, N) int32."""
    b, n = boxes.shape[:2]
    count = torch.zeros((b, n), dtype=torch.int32, device=boxes.device)
    terms = box_terms(boxes, eps)
    for i in range(b if points.shape[1] and n else 0):
        cell, cover = box_cells(points[i], boxes[i], eps)
        col, row = cell % GRID, cell // GRID
        tested = ((col[None] >= cover[:, :1]) & (col[None] <= cover[:, 1:2]) &
                  (row[None] >= cover[:, 2:3]) & (row[None] <= cover[:, 3:]) |
                  (cell == GRID * GRID)[None])               # (N, P)
        for j in range(n):
            pts = points[i, tested[j], :3]
            t = terms[i, j]
            shift = pts - t[:3]
            lx = shift[:, 0] * t[3] - shift[:, 1] * t[4]
            ly = shift[:, 0] * t[4] + shift[:, 1] * t[3]
            count[i, j] = int(((lx.abs() <= t[5]) & (ly.abs() <= t[6]) &
                               (shift[:, 2].abs() <= t[7])).sum())
    return count


def scratch_bytes(b, p):
    """K9's scratch: the points sorted by cell (16 bytes a point), each
    cell's first point (GRID ** 2 + 2 ints) and the grid (32 bytes), a
    scene."""
    return b * (16 * p + 4 * (GRID * GRID + 2) + 32)


def box_point_count_cuda(points, boxes, eps=1e-6):
    """Kernel K9 (csrc/box_count.cu): float32 points (B, P, >=3) on the
    card read through their strides, float32 boxes (B, N, 7) on the same
    card.  Four launches: the yaw's cosine and sine, the bin kernel, the
    count kernel, which writes every count.  Raises on other dtypes or
    shapes and beyond the kernels' limits (B up to 65,535 scenes, P up to
    524,280 points)."""
    for name, t in (('points', points), ('boxes', boxes)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be torch.float32, got {t.dtype}')
        if t.dim() != 3:
            raise ValueError(f'{name} must have 3 dims, got '
                             f'{tuple(t.shape)}')
    b, p = points.shape[:2]
    if points.shape[-1] < 3 or boxes.shape[0] != b or \
            boxes.shape[-1] != 7 or boxes.device != points.device:
        raise ValueError(f'boxes {tuple(boxes.shape)} on {boxes.device} do '
                         f'not go with points {tuple(points.shape)} on '
                         f'{points.device}')
    n = boxes.shape[1]
    if b > MAX_SCENES or p > MAX_POINTS:
        raise ValueError(f'{b} scenes of {p} points exceed the limits of K9')
    if not (b and n and p):
        return torch.zeros((b, n), dtype=torch.int32, device=boxes.device)
    boxes = boxes.contiguous()
    yaw = boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    scratch = torch.empty(scratch_bytes(b, p), dtype=torch.uint8,
                          device=boxes.device)
    count = torch.empty((b, n), dtype=torch.int32, device=boxes.device)
    BOX_COUNT_KERNEL(points.data_ptr(), boxes.data_ptr(), cos.data_ptr(),
                     sin.data_ptr(), scratch.data_ptr(), count.data_ptr(), b,
                     p, n, *points.stride(), ctypes.c_float(eps), GRID)
    return count
