"""Test-time augmentation: flip-ensemble inference and box merging (port of
``demf_tpu/engine/aug_test.py``; mmdet3d ``aug_test`` +
``merge_aug_bboxes_3d``).

The detector runs on the batch and on its BEV-horizontal flip (points
x -> -x, the meta's ``pcd_horizontal_flip`` toggled, so DeMF's and
ImVoteNet's projection still lands in the unflipped image); the flipped
detections are mapped back (x -> -x, yaw -> pi - yaw), both padded sets are
concatenated, shifted to their bottom centres, and merged by the aligned
3D NMS (K8 on the card).  As in the JAX package, ``eval.py`` does not call
it.
"""
from __future__ import annotations

import math

import torch

from ..core import boxes as box_ops
from ..ops._cuda import SMEM_PER_BLOCK
from ..ops.nms import aligned_3d_nms, nms_shared_bytes
from .evaluation import make_eval_step

# the most boxes a scene that one K8 block sweeps (its bits in shared memory)
NMS_ROWS = max(n for n in range(1, 4096)
               if nms_shared_bytes(n) <= SMEM_PER_BLOCK)


def flip_batch(batch):
    """BEV-horizontal flip of a collated batch (points x -> -x)."""
    out = dict(batch)
    pts = batch['points'].clone()
    pts[..., 0] = -pts[..., 0]
    out['points'] = pts
    meta = dict(batch.get('img_meta', {}))
    if 'pcd_horizontal_flip' in meta:
        meta['pcd_horizontal_flip'] = ~meta['pcd_horizontal_flip']
    out['img_meta'] = meta
    return out


def unflip_boxes(boxes):
    """Map detections from the flipped frame back to the original."""
    out = boxes.clone()
    out[..., 0] = -boxes[..., 0]
    out[..., 6] = math.pi - boxes[..., 6]
    return out


def merge_nms(boxes, scores, labels, valid, thresh, rows=NMS_ROWS):
    """Keep mask of the aligned 3D NMS over padded detections (B, M):
    the bottom-centred boxes' axis-aligned extents, same-class suppression,
    one launch.  A scene of more than ``rows`` boxes (K8's limit) is cut
    by class: each (scene, class) becomes a row of its own, in index
    order, which gives the same mask, since boxes of two classes never
    suppress each other."""
    bottom = boxes.clone()
    bottom[..., 2] = boxes[..., 2] - boxes[..., 5] / 2.
    b, m = scores.shape
    minmax = box_ops.corners_minmax(bottom.reshape(b * m, 7)).reshape(b, m, 6)
    labels = labels.long()
    if m <= rows:
        return aligned_3d_nms(minmax, scores, labels, thresh, valid=valid)
    order = torch.argsort(labels, dim=1, stable=True)
    lab = torch.gather(labels, 1, order)
    c = int(labels.max()) + 1
    counts = torch.zeros((b, c), dtype=torch.long, device=labels.device)
    counts.scatter_add_(1, lab, torch.ones_like(lab))
    width = int(counts.max())
    start = torch.cumsum(counts, 1) - counts
    col = torch.arange(m, device=labels.device) - torch.gather(start, 1, lab)
    row = torch.arange(b, device=labels.device)[:, None] * c + lab

    def grouped(x, fill):
        out = x.new_full((b * c, width) + x.shape[2:], fill)
        src = torch.gather(x, 1, order.reshape(order.shape + (1,) * (
            x.dim() - 2)).expand(order.shape + x.shape[2:]))
        out[row, col] = src
        return out

    keep = aligned_3d_nms(grouped(minmax, 0.), grouped(scores, 0.),
                          grouped(labels, 0), thresh,
                          valid=grouped(valid, False))
    return torch.zeros_like(valid).scatter(1, order, keep[row, col])


def aug_test_3d(model, batch, nms_thr=0.25, use_flip=True,
                compute_dtype=None):
    """Flip-ensemble inference.

    Args:
        model: detector in eval mode; batch: collated tensors on its device
            (points [+ img / img_features, img_meta]).
    Returns:
        padded dict(boxes_3d, scores_3d, labels_3d, valid) merged over the
        augmentations (2K detections a scene with the flip).
    """
    eval_step = make_eval_step(model, compute_dtype)
    dets = [eval_step(batch)]
    if use_flip:
        flipped = dict(eval_step(flip_batch(batch)))
        flipped['boxes_3d'] = unflip_boxes(flipped['boxes_3d'])
        dets.append(flipped)
    out = {k: torch.cat([d[k] for d in dets], 1)
           for k in ('boxes_3d', 'scores_3d', 'labels_3d', 'valid')}
    keep = merge_nms(out['boxes_3d'], out['scores_3d'], out['labels_3d'],
                     out['valid'], nms_thr)
    out['valid'] = keep & out['valid']
    return out
