"""VoteFusion: 2D detections lifted to per-seed image votes (port of
``demf_tpu/models/vote_fusion.py``).

2D boxes come as a padded (B, K, 6) tensor [x1, y1, x2, y2, score, class],
sorted by score, with a validity mask.  For each seed and slot k <
``max_imvote_per_pixel``, the k-th valid box (in that order) that contains
the seed's projected pixel gives one 18-dim image vote: the 2D offset to
the box centre over the image size (2), the pseudo 3D vote from the seed
to the point on the box centre's camera ray at the seed's depth, in the
augmented frame (3), the class one-hot (10), and the RGB at the seed's
pixel (3, given to every slot).  The output is slot-major (flat index =
slot * num_seeds + seed), so ``index % num_seeds`` is the seed.

``sample_valid_seeds`` draws its uniforms from a ``torch.Generator`` or
takes them from the caller (the tests feed in the JAX package's draws:
threefry's numbers cannot be reproduced).
"""
from __future__ import annotations

import torch

from ..core.transforms import forward_2d_transform, reverse_3d_transform


def project_seeds_to_pixels(seeds, meta):
    """Seeds (B, N, 3) in the augmented frame -> (uv in the transformed
    image (B, N, 2), camera depth (B, N), the seeds in the original depth
    frame (B, N, 3))."""
    xyz_depth = reverse_3d_transform(seeds, meta)
    hom = torch.cat([xyz_depth, torch.ones_like(xyz_depth[..., :1])], -1)
    p2d = torch.einsum('bnj,bkj->bnk', hom, meta['depth2img'])
    depth = p2d[..., 2].clamp_min(1e-6)
    uv = forward_2d_transform(p2d[..., :2] / depth[..., None], meta)
    return uv, depth, xyz_depth


def reverse_pixel_to_depth_frame(uv_t, depth, meta):
    """A pixel of the transformed image (B, N, 2) and a camera depth (B, N)
    -> the point in the original depth frame (B, N, 3): the 2D transform
    undone (unflip, then unscale), then the inverse of ``depth2img``'s 3x3
    part applied to (u z, v z, z)."""
    u = uv_t[..., 0]
    if 'flip' in meta and 'img_shape' in meta:
        w = meta['img_shape'][:, 1].to(u.dtype)[:, None]
        u = torch.where(meta['flip'][:, None], w - u, u)
    uv = torch.stack([u, uv_t[..., 1]], -1)
    if 'scale_factor' in meta:
        uv = uv / meta['scale_factor'][:, None, :2]
    rhs = torch.cat([uv * depth[..., None], depth[..., None]], -1)
    inv = torch.linalg.inv(meta['depth2img'][:, :3, :3])
    return torch.einsum('bnj,bkj->bnk', rhs, inv)


def apply_3d_aug_to_vector(vec, meta):
    """The recorded 3D augmentation (flip, rotation, scale; no translation)
    applied forward to vectors (B, N, 3)."""
    v = vec
    if 'pcd_horizontal_flip' in meta:
        flip = meta['pcd_horizontal_flip'][:, None]
        v = torch.cat([torch.where(flip, -v[..., 0], v[..., 0])[..., None],
                       v[..., 1:]], -1)
    if 'pcd_rotation' in meta:
        v = torch.einsum('bnj,bjk->bnk', v, meta['pcd_rotation'])
    if 'pcd_scale_factor' in meta:
        v = v * meta['pcd_scale_factor'][:, None, None]
    return v


class VoteFusion:
    """Stateless fusion op (no learned parameters)."""

    def __init__(self, num_classes=10, max_imvote_per_pixel=3):
        self.num_classes = num_classes
        self.max_imvote_per_pixel = max_imvote_per_pixel

    def __call__(self, img, bboxes_2d, box_valid, seeds, meta):
        """img (B, H, W, 3) normalized (NHWC); bboxes_2d (B, K, 6)
        score-sorted; box_valid (B, K) bool; seeds (B, N, 3) ->
        (feats (B, N * slots, 18) slot-major, mask (B, N * slots))."""
        uv, depth, xyz_depth = project_seeds_to_pixels(seeds, meta)
        u, v = uv[..., 0], uv[..., 1]
        boxes = bboxes_2d[..., :4]
        inside = ((u[:, :, None] >= boxes[:, None, :, 0]) &
                  (u[:, :, None] <= boxes[:, None, :, 2]) &
                  (v[:, :, None] >= boxes[:, None, :, 1]) &
                  (v[:, :, None] <= boxes[:, None, :, 3]) &
                  box_valid[:, None, :])                       # (B, N, K)
        inside_i = inside.int()
        cnt_excl = torch.cumsum(inside_i, -1) - inside_i
        h_img = meta['img_shape'][:, 0].float()[:, None]
        w_img = meta['img_shape'][:, 1].float()[:, None]

        # the texture cue at the seed's pixel: truncated, clamped (the float
        # first, so that a seed behind the camera converts as XLA saturates)
        hi, wi = img.shape[1], img.shape[2]
        ui = u.clamp(-1, wi).long().clamp(0, wi - 1)
        vi = v.clamp(-1, hi).long().clamp(0, hi - 1)
        scene = torch.arange(img.shape[0], device=img.device)[:, None]
        tex = img[scene, vi, ui]                               # (B, N, 3)
        classes = torch.arange(self.num_classes, device=img.device)

        feats, masks = [], []
        for k in range(self.max_imvote_per_pixel):
            mk = inside & (cnt_excl == k)
            hask = mk.any(-1)
            idxk = mk.to(torch.uint8).argmax(-1)
            box_k = torch.gather(bboxes_2d, 1, idxk[..., None].expand(
                -1, -1, bboxes_2d.shape[-1]))
            cx = (box_k[..., 0] + box_k[..., 2]) / 2
            cy = (box_k[..., 1] + box_k[..., 3]) / 2
            du = (cx - u) / w_img
            dv = (cy - v) / h_img
            target = reverse_pixel_to_depth_frame(
                torch.stack([cx, cy], -1), depth, meta)
            vote3d = apply_3d_aug_to_vector(target - xyz_depth, meta)
            sem = (box_k[..., 5].to(torch.int32)[..., None] ==
                   classes).to(vote3d.dtype)
            f = torch.cat([du[..., None], dv[..., None], vote3d, sem], -1)
            f = torch.where(hask[..., None], f, 0.)
            feats.append(torch.cat([f, tex.to(f.dtype)], -1))
            masks.append(hask)
        return torch.cat(feats, 1), torch.cat(masks, 1)


def sample_valid_seeds(mask, num_sampled_seed, generator=None, u=None):
    """``num_sampled_seed`` imvote indices an image (B, S) int64: a random
    subset of the valid (box-matched) imvotes, topped up with random
    indices from [0, num_sampled_seed) where there are fewer (the
    reference's ``% num_sampled_seed`` fill rule), by one sort of
    ``2 * mask + (index < S) + u``.  The uniforms ``u`` (B, N * slots) are
    the caller's, or drawn from ``generator``."""
    b, total = mask.shape
    if u is None:
        u = torch.rand((b, total), generator=generator, device=mask.device)
    idx = torch.arange(total, device=mask.device)
    key = mask.float() * 2.0 + (idx < num_sampled_seed).float() + u
    _, order = torch.sort(key, dim=-1, descending=True, stable=True)
    return order[:, :num_sampled_seed]
