"""2D training assignment and sampling of the Faster R-CNN branch (port of
``demf_tpu/models/assign_sample.py``: mmdet's ``MaxIoUAssigner`` and
``RandomSampler`` as fixed-shape masks).

The assigner returns a code an anchor (-2 ignore, -1 negative, >= 0 the
index of its GT box); the sampler returns positive and negative masks
drawn by a random top-k.  Both take a batch: the leading axes broadcast,
where the JAX package maps a function of one image over them.  The
sampler's uniforms come from a ``torch.Generator`` or as arguments (the
tests pass the JAX package's draws); its top-k sorts stably, as
``jax.lax.top_k`` orders equal keys (``rpn_roi.topk_stable``).
"""
from __future__ import annotations

import torch

from .rpn_roi import topk_stable


def iou_2d(a, b):
    """(..., A, 4) x (..., G, 4) xyxy -> the (..., A, G) IoU matrix."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    wh_a = (a[..., 2:] - a[..., :2]).clamp_min(0)
    wh_b = (b[..., 2:] - b[..., :2]).clamp_min(0)
    area_a = wh_a[..., 0] * wh_a[..., 1]
    area_b = wh_b[..., 0] * wh_b[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] -
                    inter).clamp_min(1e-7)


def max_iou_assign(ious, gt_valid, pos_iou_thr, neg_iou_thr, min_pos_iou=0.,
                   match_low_quality=True):
    """mmdet ``MaxIoUAssigner.assign`` on (..., A, G) IoUs and (..., G)
    valid GT -> (..., A) int64 codes.  With ``match_low_quality`` each valid
    GT claims the anchors at its best IoU (when that is at least
    ``min_pos_iou``); an anchor claimed by several takes the last of them,
    as mmdet's loop over the GT in order leaves it."""
    ious = torch.where(gt_valid[..., None, :], ious,
                       torch.full_like(ious, -1.0))
    max_iou = ious.max(-1).values
    argmax_gt = ious.argmax(-1)
    assigned = torch.full_like(argmax_gt, -2)
    assigned = torch.where(max_iou < neg_iou_thr, -1, assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax_gt, assigned)
    if match_low_quality:
        gt_best = ious.max(-2, keepdim=True).values
        claims = (ious == gt_best) & (gt_best >= min_pos_iou) & \
            gt_valid[..., None, :]
        g = ious.shape[-1]
        last_claim = (g - 1) - claims.flip(-1).to(torch.uint8).argmax(-1)
        assigned = torch.where(claims.any(-1), last_claim, assigned)
    return assigned


def _top_mask(key, k, take=None):
    """The (..., A) mask of the ``k`` largest keys that are > 0 (and, where
    given, whose rank ``take`` (..., k) allows)."""
    topv, topi = topk_stable(key, k)
    keep = topv > 0
    if take is not None:
        keep = keep & take
    return torch.zeros(key.shape, dtype=torch.bool,
                       device=key.device).scatter(-1, topi, keep)


def random_sample(assigned, num, pos_fraction, generator=None, u_pos=None,
                  u_neg=None):
    """mmdet ``RandomSampler`` on (..., A) codes -> (pos, neg) masks: at
    most ``num * pos_fraction`` positives, negatives to fill ``num``, each
    set the top of its uniform keys (``u_pos`` / ``u_neg`` (..., A), the
    caller's, or drawn from ``generator`` in that order).  A key of 0 is
    not taken, as in the JAX package."""
    a = assigned.shape[-1]
    if u_pos is None:
        u_pos = torch.rand(assigned.shape, generator=generator,
                           device=assigned.device)
    if u_neg is None:
        u_neg = torch.rand(assigned.shape, generator=generator,
                           device=assigned.device)
    minus = torch.full_like(u_pos, -1.0)
    pos = _top_mask(torch.where(assigned >= 0, u_pos, minus),
                    min(int(num * pos_fraction), a))
    k_neg = min(num, a)
    room = num - pos.sum(-1, keepdim=True)
    neg = _top_mask(torch.where(assigned == -1, u_neg, minus), k_neg,
                    torch.arange(k_neg, device=assigned.device) < room)
    return pos, neg
