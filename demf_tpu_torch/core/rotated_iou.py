"""Rotated 3D IoU of depth boxes, plain PyTorch on any device (port of
``demf_tpu/core/rotated_iou.py``).

Boxes are (x, y, z_bottom, dx, dy, dz, yaw) with ``core.boxes``'s rotation
sense (x' = x cos + y sin).  The BEV intersection is the sort-vertices
form: the candidate vertices of the convex intersection of two rectangles
are the corners of each inside the other (8) and the 16 edge-pair
crossings; the valid ones are ordered by angle around their centroid and
the shoelace sum gives the area (invalid slots repeat the first vertex and
add nothing).  Height overlap times that area over the union of volumes.
The JAX package keeps the pair axis minor to fill the TPU's lanes; here
the pair axis is last only because it reads the same.

The mAP's ``core/eval3d.py::rotated_iou_3d`` (host side, numpy) is another
function and stays the mAP's.  The rotated NMS of the FCAF3D family is
``ops/nms_rotated.py`` (kernel K15), whose plain version is
``iou3d_matrix`` here and ``ops/nms.py::greedy_suppress``.
"""
from __future__ import annotations

import torch

_SIGNS_X = (-0.5, 0.5, 0.5, -0.5)
_SIGNS_Y = (-0.5, -0.5, 0.5, 0.5)


def bev_corners(box):
    """(..., 7) -> (..., 4, 2) CCW BEV corners."""
    x, y, dx, dy, yaw = (box[..., i] for i in (0, 1, 3, 4, 6))
    sx = box.new_tensor(_SIGNS_X)
    sy = box.new_tensor(_SIGNS_Y)
    lx = sx * dx[..., None]
    ly = sy * dy[..., None]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    wx = lx * c + ly * s + x[..., None]
    wy = -lx * s + ly * c + y[..., None]
    return torch.stack([wx, wy], -1)


def _bev_corners_t(boxes):
    """(P, 7) -> (x, y) each (4, P): the CCW BEV corners, pair axis last."""
    x, y, dx, dy, yaw = (boxes[:, i] for i in (0, 1, 3, 4, 6))
    lx = boxes.new_tensor(_SIGNS_X)[:, None] * dx[None]
    ly = boxes.new_tensor(_SIGNS_Y)[:, None] * dy[None]
    c, s = torch.cos(yaw)[None], torch.sin(yaw)[None]
    return lx * c + ly * s + x[None], -lx * s + ly * c + y[None]


def _inside(px, py, qx, qy):
    """(4, P) points inside the convex CCW quads (4, P): left of every
    edge, within 1e-9."""
    ex = torch.roll(qx, -1, 0) - qx
    ey = torch.roll(qy, -1, 0) - qy
    dx = px[:, None] - qx[None]
    dy = py[:, None] - qy[None]
    cr = ex[None] * dy - ey[None] * dx
    return (cr >= -1e-9).all(1)


def bev_intersection_batched(boxes1, boxes2):
    """(P, 7) x (P, 7) -> (P,) BEV intersection areas."""
    ax, ay = _bev_corners_t(boxes1)
    bx, by = _bev_corners_t(boxes2)
    in_ab = _inside(ax, ay, bx, by)
    in_ba = _inside(bx, by, ax, ay)

    dax = (torch.roll(ax, -1, 0) - ax)[:, None]     # (4, 1, P)
    day = (torch.roll(ay, -1, 0) - ay)[:, None]
    dbx = (torch.roll(bx, -1, 0) - bx)[None]        # (1, 4, P)
    dby = (torch.roll(by, -1, 0) - by)[None]
    rx = ax[:, None] - bx[None]                     # (4, 4, P)
    ry = ay[:, None] - by[None]
    denom = dax * dby - day * dbx
    small = denom.abs() < 1e-12
    safe = torch.where(small, torch.full_like(denom, 1e-12), denom)
    t = (dbx * ry - dby * rx) / safe
    u = (dax * ry - day * rx) / safe
    hit = (denom.abs() > 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    ix = ax[:, None] + t * dax
    iy = ay[:, None] + t * day

    p = ax.shape[1]
    cx = torch.cat([ax, bx, ix.reshape(16, p)])     # (24, P)
    cy = torch.cat([ay, by, iy.reshape(16, p)])
    valid = torch.cat([in_ab, in_ba, hit.reshape(16, p)])

    n = valid.sum(0)
    w = valid.to(cx.dtype)
    nf = n.clamp(min=1).to(cx.dtype)
    cenx = (cx * w).sum(0) / nf
    ceny = (cy * w).sum(0) / nf
    ang = torch.atan2(cy - ceny[None], cx - cenx[None])
    ang = torch.where(valid, ang, torch.full_like(ang, float('inf')))
    order = torch.argsort(ang, dim=0, stable=True)
    xs = cx.gather(0, order)
    ys = cy.gather(0, order)
    keep = torch.arange(24, device=cx.device)[:, None] < n[None]
    xs = torch.where(keep, xs, xs[:1])
    ys = torch.where(keep, ys, ys[:1])
    x2 = torch.roll(xs, -1, 0)
    y2 = torch.roll(ys, -1, 0)
    area = 0.5 * (xs * y2 - x2 * ys).sum(0).abs()
    return torch.where(n >= 3, area, torch.zeros_like(area))


def _iou3d_batched(boxes1, boxes2, eps=1e-7):
    """(P, 7) x (P, 7) -> (P,) rotated 3D IoU."""
    inter2d = bev_intersection_batched(boxes1, boxes2)
    zmin = torch.maximum(boxes1[:, 2], boxes2[:, 2])
    zmax = torch.minimum(boxes1[:, 2] + boxes1[:, 5],
                         boxes2[:, 2] + boxes2[:, 5])
    inter = inter2d * (zmax - zmin).clamp(min=0.0)
    vol1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    vol2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / (vol1 + vol2 - inter).clamp(min=eps)


def iou3d_aligned(boxes1, boxes2):
    """Element-wise rotated IoU of two (N, 7) box sets -> (N,)."""
    return _iou3d_batched(boxes1, boxes2)


def iou3d_matrix(boxes1, boxes2):
    """(..., N, 7) x (..., M, 7) -> (..., N, M) rotated IoU matrix; leading
    axes are a batch."""
    n, m = boxes1.shape[-2], boxes2.shape[-2]
    lead = boxes1.shape[:-2]
    a = boxes1[..., :, None, :].expand(*lead, n, m, 7).reshape(-1, 7)
    b = boxes2[..., None, :, :].expand(*lead, n, m, 7).reshape(-1, 7)
    return _iou3d_batched(a, b).reshape(*lead, n, m)


def rotated_nms_3d(boxes, scores, classes, thresh, valid=None):
    """Greedy class-aware rotated 3D NMS of (B, N) boxes: the IoU matrix
    zeroed between classes, then ``ops/nms.py::greedy_suppress`` ->
    (B, N) keep mask."""
    from ..ops.nms import greedy_suppress
    iou = iou3d_matrix(boxes, boxes)
    iou = torch.where(classes[..., :, None] == classes[..., None, :], iou,
                      torch.zeros_like(iou))
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    return greedy_suppress(iou, scores, thresh, valid)
