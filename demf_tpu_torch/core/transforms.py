"""Batched coordinate transforms of the DeMF reference-point bridge (port of
``demf_tpu/core/transforms.py``): undo the 3D augmentation, project with
``depth2img``, apply the 2D augmentation, normalize to [0, 1]."""
from __future__ import annotations

import torch


def reverse_3d_transform(points, meta):
    """(B, N, 3) augmented-frame points -> original depth frame.

    Undoes T, then S, then R (forward p' = p @ M), then the horizontal flip,
    for whichever of ``pcd_trans``, ``pcd_scale_factor``, ``pcd_rotation``
    and ``pcd_horizontal_flip`` the meta holds.
    """
    p = points
    if 'pcd_trans' in meta:
        p = p - meta['pcd_trans'][:, None, :]
    if 'pcd_scale_factor' in meta:
        p = p / meta['pcd_scale_factor'][:, None, None]
    if 'pcd_rotation' in meta:
        p = torch.einsum('bnj,bkj->bnk', p, meta['pcd_rotation'])
    if 'pcd_horizontal_flip' in meta:
        flip = meta['pcd_horizontal_flip'][:, None]
        x = torch.where(flip, -p[..., 0], p[..., 0])
        p = torch.cat([x[..., None], p[..., 1:]], -1)
    return p


def forward_2d_transform(uv, meta):
    """Original-image pixel coords -> augmented-image coords (scale, then
    horizontal flip)."""
    if 'scale_factor' in meta:
        uv = uv * meta['scale_factor'][:, None, :2]
    if 'flip' in meta and 'img_shape' in meta:
        w = meta['img_shape'][:, 1].to(uv.dtype)[:, None]
        u = torch.where(meta['flip'][:, None], w - uv[..., 0], uv[..., 0])
        uv = torch.stack([u, uv[..., 1]], -1)
    return uv


def project_points_to_image(points, meta, clamp=True):
    """(B, N, 3) points -> (B, N, 2) normalized (u, v), by (img_shape - 1)."""
    xyz = reverse_3d_transform(points, meta)
    hom = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)
    p2d = torch.einsum('bnj,bkj->bnk', hom, meta['depth2img'])
    uv = p2d[..., :2] / p2d[..., 2:3].clamp_min(1e-6)
    uv = forward_2d_transform(uv, meta)
    shape = meta['img_shape'].to(uv.dtype)
    uv = torch.stack([uv[..., 0] / (shape[:, 1:2] - 1),
                      uv[..., 1] / (shape[:, 0:1] - 1)], -1)
    if clamp:
        uv = uv.clamp(0.0, 1.0)
    return uv
