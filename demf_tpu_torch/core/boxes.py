"""3D box geometry for depth-coordinate boxes (port of
``demf_tpu/core/boxes.py``).

Boxes are ``(..., 7)`` tensors ``[x, y, z, dx, dy, dz, yaw]`` with the
bottom-center origin of mmdet3d 0.18 ``DepthInstance3DBoxes``.
"""
from __future__ import annotations

import numpy as np
import torch


def rotation_3d_in_axis(points, angles, axis=2):
    """Rotate (N, M, 3) points by per-row (N,) angles (mmdet3d 0.18
    convention: for axis 2, x' = x cos + y sin, y' = -x sin + y cos)."""
    s, c = torch.sin(angles), torch.cos(angles)
    ones, zeros = torch.ones_like(c), torch.zeros_like(c)
    if axis == 1:
        rows = ((c, zeros, -s), (zeros, ones, zeros), (s, zeros, c))
    elif axis in (2, -1):
        rows = ((c, -s, zeros), (s, c, zeros), (zeros, zeros, ones))
    elif axis == 0:
        rows = ((ones, zeros, zeros), (zeros, c, -s), (zeros, s, c))
    else:
        raise ValueError(f'axis should be in range [0, 2], got {axis}')
    rot = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return torch.einsum('aij,ajk->aik', points, rot)


def limit_period(val, offset=0.5, period=np.pi):
    """mmdet3d ``limit_period``."""
    return val - torch.floor(val / period + offset) * period


def gravity_center(boxes):
    """Bottom-center boxes -> (..., 3) gravity centers."""
    return torch.cat([boxes[..., :2], boxes[..., 2:3] + boxes[..., 5:6] * 0.5],
                     -1)


_CORNERS_NORM = np.stack(np.unravel_index(np.arange(8), [2] * 3),
                         axis=1)[[0, 1, 3, 2, 4, 5, 7, 6]] - \
    np.array([0.5, 0.5, 0.0])


def box_corners(boxes):
    """(N, 7) boxes -> (N, 8, 3) corners in mmdet3d 0.18 order."""
    norm = torch.as_tensor(_CORNERS_NORM, dtype=boxes.dtype,
                           device=boxes.device)
    corners = boxes[..., None, 3:6] * norm
    corners = rotation_3d_in_axis(corners, boxes[..., 6], axis=2)
    return corners + boxes[..., None, :3]


def points_in_boxes(points, boxes, eps=1e-6):
    """(..., P, 3) points x (..., N, 7) boxes -> (..., P, N) bool
    membership, with the ``box_corners``-consistent rotation sense."""
    centers = gravity_center(boxes)
    shift = points[..., :, None, :] - centers[..., None, :, :]
    c = torch.cos(boxes[..., None, :, 6])
    s = torch.sin(boxes[..., None, :, 6])
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    half = boxes[..., None, :, 3:6] * 0.5
    return ((lx.abs() <= half[..., 0] + eps) &
            (ly.abs() <= half[..., 1] + eps) &
            (shift[..., 2].abs() <= half[..., 2] + eps))


def corners_minmax(boxes):
    """(N, 7) rotated boxes -> (N, 6) axis-aligned [min_xyz, max_xyz]."""
    c = box_corners(boxes)
    return torch.cat([c.amin(-2), c.amax(-2)], -1)


def aligned_box_iou_3d(boxes1, boxes2):
    """(N, 6) x (M, 6) axis-aligned boxes -> (N, M) IoU."""
    lt = torch.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
    rb = torch.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    vol1 = (boxes1[:, 3:] - boxes1[:, :3]).clamp_min(0).prod(-1)
    vol2 = (boxes2[:, 3:] - boxes2[:, :3]).clamp_min(0).prod(-1)
    return inter / (vol1[:, None] + vol2[None, :] - inter).clamp_min(1e-8)


def angle2class(angle, num_dir_bins):
    """Angle -> (direction bin, residual), mmdet3d
    ``PartialBinBasedBBoxCoder.angle2class``."""
    angle = torch.remainder(angle, 2 * np.pi)
    angle_per_class = 2 * np.pi / float(num_dir_bins)
    shifted = torch.remainder(angle + angle_per_class / 2, 2 * np.pi)
    angle_cls = torch.div(shifted, angle_per_class, rounding_mode='floor')
    angle_res = shifted - (angle_cls * angle_per_class + angle_per_class / 2)
    return angle_cls.long(), angle_res


def class2angle(angle_cls, angle_res, num_dir_bins, limit_period_flag=True):
    """Direction bin + residual -> angle (inverse of ``angle2class``)."""
    angle_per_class = 2 * np.pi / float(num_dir_bins)
    angle = angle_cls.to(angle_res.dtype) * angle_per_class + angle_res
    if limit_period_flag:
        angle = torch.where(angle > np.pi, angle - 2 * np.pi, angle)
    return angle
