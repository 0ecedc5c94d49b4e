"""Fixed-shape greedy 3D NMS on the device, batched over B (plain torch).

Port of ``demf_tpu/ops/nms.py`` (``_greedy_suppress``, ``aligned_3d_nms``).
The greedy sweep is N sequential steps of a few small launches each; it
stays on the device and is a candidate for a kernel of its own.
"""
from __future__ import annotations

import torch


def greedy_suppress(iou, scores, thresh, valid):
    """Score-ordered greedy suppression over a precomputed IoU matrix.

    Args:
        iou: (B, N, N) pairwise IoU (already class-masked if needed).
        scores: (B, N).
        thresh: suppress when iou > thresh.
        valid: (B, N) bool; invalid entries are never kept.
    Returns:
        (B, N) bool keep mask in the original order.
    """
    b, n = scores.shape
    neg_inf = torch.full_like(scores, float('-inf'))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    iou_s = torch.gather(iou, 1, order[:, :, None].expand(-1, -1, n))
    iou_s = torch.gather(iou_s, 2, order[:, None, :].expand(-1, n, -1))
    later = torch.ones(n, n, dtype=torch.bool, device=iou.device).triu(1)
    sup = (iou_s > thresh) & later
    keep = torch.gather(valid, 1, order)
    for i in range(n):
        keep = keep & ~(keep[:, i:i + 1] & sup[:, i])
    return torch.zeros_like(keep).scatter(1, order, keep)


def aligned_3d_nms(boxes, scores, classes, thresh, valid=None):
    """Axis-aligned 3D NMS, same-class suppression only.

    boxes (B, N, 6) as (x1, y1, z1, x2, y2, z2), scores (B, N), classes
    (B, N) -> (B, N) bool keep mask.
    """
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    lt = torch.maximum(boxes[:, :, None, :3], boxes[:, None, :, :3])
    rb = torch.minimum(boxes[:, :, None, 3:], boxes[:, None, :, 3:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    vol = (boxes[..., 3:] - boxes[..., :3]).clamp_min(0).prod(-1)
    iou = inter / (vol[:, :, None] + vol[:, None, :] - inter).clamp_min(1e-8)
    iou = iou * (classes[:, :, None] == classes[:, None, :])
    return greedy_suppress(iou, scores, thresh, valid)
