"""Losses with mmdet weighting semantics (port of
``demf_tpu/models/losses.py``): each loss is elementwise, multiplied by a
caller-given ``weight`` tensor (normalized over the whole batch by the
heads), reduced and scaled by ``loss_weight``.  Registered in the port's
``LOSSES`` so ``dict(type='SmoothL1Loss', ...)`` configs build as they
are."""
from __future__ import annotations

import torch

from ..registry import LOSSES


def _reduce(loss, reduction):
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if reduction == 'mean':
        return loss.mean()
    raise ValueError(reduction)


def weight_reduce_loss(loss, weight=None, reduction='mean', avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return _reduce(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / avg_factor
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor only supported with mean/none reduction')


@LOSSES.register_module()
class CrossEntropyLoss:
    """Softmax cross entropy over class-last logits ``pred`` (..., C) and
    integer ``label`` (...), with optional per-class weights."""

    def __init__(self, use_sigmoid=False, class_weight=None, reduction='mean',
                 loss_weight=1.0):
        if use_sigmoid:
            raise NotImplementedError('the port has the softmax form only')
        self.class_weight = (None if class_weight is None else
                             torch.tensor(class_weight, dtype=torch.float32))
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, label, weight=None, avg_factor=None):
        label = label.long()
        logp = torch.log_softmax(pred, -1)
        loss = -torch.gather(logp, -1, label[..., None])[..., 0]
        if self.class_weight is not None:
            loss = loss * self.class_weight.to(pred)[label]
        return self.loss_weight * weight_reduce_loss(
            loss, weight, self.reduction, avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    def __init__(self, beta=1.0, reduction='mean', loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        diff = (pred - target).abs()
        if self.beta <= 0:
            loss = diff
        else:
            loss = torch.where(diff < self.beta,
                               0.5 * diff * diff / self.beta,
                               diff - 0.5 * self.beta)
        return self.loss_weight * weight_reduce_loss(
            loss, weight, self.reduction, avg_factor)


@LOSSES.register_module()
class L1Loss:
    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * weight_reduce_loss(
            (pred - target).abs(), weight, self.reduction, avg_factor)


@LOSSES.register_module()
class AxisAlignedIoULoss:
    """1 - IoU of axis-aligned 3D corner boxes (x1y1z1x2y2z2)."""

    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        lt = torch.maximum(pred[..., :3], target[..., :3])
        rb = torch.minimum(pred[..., 3:], target[..., 3:])
        inter = (rb - lt).clamp_min(0).prod(-1)
        vol_p = (pred[..., 3:] - pred[..., :3]).clamp_min(0).prod(-1)
        vol_t = (target[..., 3:] - target[..., :3]).clamp_min(0).prod(-1)
        iou = inter / (vol_p + vol_t - inter).clamp_min(1e-8)
        return self.loss_weight * weight_reduce_loss(
            1.0 - iou, weight, self.reduction, avg_factor)


def chamfer_distance(src, dst, src_weight=1.0, dst_weight=1.0, mode='l2',
                     dst_valid=None):
    """Pairwise min-distance assignment (mmdet3d ``chamfer_distance``).

    src (B, N, C), dst (B, M, C), optional dst_valid (B, M) bool (an invalid
    dst is never assigned) -> (loss_src (B, N), loss_dst (B, M),
    indices1 (B, N), indices2 (B, M)); ties go to the lowest index.
    """
    diff = src[:, :, None, :] - dst[:, None, :, :]
    if mode == 'l2':
        distance = (diff * diff).sum(-1)
    elif mode == 'l1':
        distance = diff.abs().sum(-1)
    elif mode == 'smooth_l1':
        d = diff.abs()
        distance = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    else:
        raise ValueError(mode)
    if dst_valid is not None:
        distance = torch.where(dst_valid[:, None, :], distance,
                               distance.new_tensor(1e10))
    src2dst, indices1 = distance.min(-1)
    dst2src, indices2 = distance.min(-2)
    return src2dst * src_weight, dst2src * dst_weight, indices1, indices2


@LOSSES.register_module()
class ChamferDistance:
    def __init__(self, mode='l2', reduction='mean', loss_src_weight=1.0,
                 loss_dst_weight=1.0):
        self.mode = mode
        self.reduction = reduction
        self.loss_src_weight = loss_src_weight
        self.loss_dst_weight = loss_dst_weight

    def __call__(self, src, dst, src_weight=1.0, dst_weight=1.0,
                 dst_valid=None, return_indices=False):
        ls, ld, i1, i2 = chamfer_distance(src, dst, src_weight, dst_weight,
                                          self.mode, dst_valid)
        ls = ls * self.loss_src_weight
        ld = ld * self.loss_dst_weight
        if self.reduction == 'sum':
            ls, ld = ls.sum(), ld.sum()
        elif self.reduction == 'mean':
            ls, ld = ls.mean(), ld.mean()
        if return_indices:
            return ls, ld, i1, i2
        return ls, ld
