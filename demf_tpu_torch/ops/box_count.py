"""Points in rotated 3D boxes, counted: CUDA kernel K9 and its plain
version.

``count[b, n]`` is the number of points of scene ``b`` inside box ``n``:
the sum over the points of ``core/boxes.py::points_in_boxes``, for a whole
batch.  Port of the non-empty-box test's count in
``demf_tpu/models/vote_head.py::multiclass_nms_3d`` (``jnp.sum(
points_in_boxes(pts[:, :3], bottom), 0)``, ``points_in_boxes`` at
``demf_tpu/core/boxes.py:105``, vmapped over the batch).

A CUDA tensor launches K9 (``csrc/box_count.cu``): one launch for the
whole batch.  A CPU tensor takes the plain version, which tests the points
a chunk at a time, so that it never holds a (P, N) temporary for the whole
batch.  Both take the per-box terms from ``box_terms`` and test in the
same order with the same roundings, so their counts are equal; a NaN point
or box counts nothing on either.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel

BOX_COUNT_KERNEL = CudaKernel(
    'demf_box_count', [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 +
    [ctypes.c_longlong] * 3)

# the plain version tests about this many (point, box) pairs at a time
PLAIN_PAIRS = 1 << 24
# the kernel's grid: boxes in tiles of 32, scenes on its third axis
KERNEL_TILE = 32
MAX_GRID_YZ = 65535


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


def box_point_count_cuda(points, boxes, eps=1e-6):
    """Kernel K9 (csrc/box_count.cu): float32 points (B, P, >=3) on the
    card read through their strides, float32 boxes (B, N, 7) on the same
    card.  Raises on other dtypes or shapes and on a batch or a box count
    beyond the grid's limits (B and N / 32 up to 65,535)."""
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
    if b > MAX_GRID_YZ or -(-n // KERNEL_TILE) > MAX_GRID_YZ:
        raise ValueError(f'{b} scenes of {n} boxes exceed the grid of K9')
    count = torch.zeros((b, n), dtype=torch.int32, device=boxes.device)
    if b and n and p:
        terms = box_terms(boxes, eps)
        BOX_COUNT_KERNEL(points.data_ptr(), terms.data_ptr(),
                         count.data_ptr(), b, p, n, *points.stride())
    return count
