"""Training targets of the vote heads, batched (port of
``demf_tpu/models/target_assign.py``; the JAX ``vmap`` over scenes is a
leading batch axis here).

  * vote targets: per point, offsets to the gravity centers of the first,
    second and *last* (>= 3rd) GT boxes that hold it, in box order;
    unfilled slots repeat the first vote;
  * proposal -> GT assignment: nearest GT gravity center;
  * objectness: positive iff within ``pos_distance_thr`` and the proposal
    lies inside the assigned (rotated) box;
  * a scene without GT gets one fake zero box with label 0.

Gradients flow as in the JAX package: the targets are computed from
``aggregated_points`` without cutting the gradient, so in mode ``'ca'``
the distance targets carry one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import boxes as box_ops
from ..parallel import global_sum


def _take(x, idx):
    """x (B, G, ...) gathered at idx (B, N) along axis 1 -> (B, N, ...)."""
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, index)


def _vote_targets(points_xyz, gt_boxes, gt_valid, gt_per_seed):
    """points_xyz (B, P, 3), gt (B, G, 7) / (B, G) -> vote_targets
    (B, P, 3 * gt_per_seed), vote_target_masks (B, P) int."""
    in_box = box_ops.points_in_boxes(points_xyz, gt_boxes) & \
        gt_valid[:, None, :]
    hits = in_box.long()
    centers = box_ops.gravity_center(gt_boxes)              # (B, G, 3)
    g = in_box.shape[-1]
    cnt_excl = hits.cumsum(-1) - hits                       # earlier hits
    has1 = in_box.any(-1)
    v_first = _take(centers, hits.argmax(-1)) - points_xyz
    slots = [v_first]
    for k in range(1, gt_per_seed):
        if k < gt_per_seed - 1:
            mk = in_box & (cnt_excl == k)
            idxk = mk.long().argmax(-1)
        else:
            # last slot: the LAST box with >= k earlier hits (overwrite rule)
            mk = in_box & (cnt_excl >= k)
            idxk = (g - 1) - mk.flip(-1).long().argmax(-1)
        vk = _take(centers, idxk) - points_xyz
        slots.append(torch.where(mk.any(-1)[..., None], vk, v_first))
    vote_targets = torch.cat(slots, -1) * has1[..., None]
    return vote_targets, has1.int()


def _assign(gt_boxes, gt_labels, gt_valid, aggregated_points, coder, pos_thr,
            neg_thr, half_size_inside):
    """Proposal -> GT assignment and regression targets, (B, N, ...)."""
    center_t, size_t, dir_cls_t, dir_res_t, dir_t = coder.encode(
        gt_boxes, gt_labels, ret_dir_target=True)
    d2 = ((aggregated_points[:, :, None] - center_t[:, None]) ** 2).sum(-1)
    d2 = torch.where(gt_valid[:, None, :], d2, d2.new_tensor(1e10))
    min_d2, assignment = d2.min(-1)
    euclid = torch.sqrt(min_d2 + 1e-6)
    objectness_masks = ((euclid < pos_thr) | (euclid > neg_thr)).float()

    center_a = _take(center_t, assignment)
    size_a = _take(size_t, assignment)
    canonical = aggregated_points - center_a
    if coder.with_rot:
        b, n = assignment.shape
        yaw_a = _take(gt_boxes[..., 6], assignment)
        canonical = box_ops.rotation_3d_in_axis(
            canonical.reshape(b * n, 1, 3), -yaw_a.reshape(b * n),
            axis=2).reshape(b, n, 3)
    half = size_a / 2.0 if half_size_inside else size_a
    distance_targets = torch.cat([half - canonical, half + canonical], -1)
    inside = (distance_targets >= 0.).all(-1)
    return dict(center_targets=center_a, size_targets=size_a,
                dir_class_targets=_take(dir_cls_t, assignment),
                dir_res_targets=_take(dir_res_t, assignment) /
                (np.pi / coder.num_dir_bins),
                dir_targets=_take(dir_t, assignment),
                mask_targets=_take(gt_labels, assignment).long(),
                objectness_targets=((euclid < pos_thr) & inside).long(),
                objectness_masks=objectness_masks,
                distance_targets=distance_targets)


def get_vote_head_targets(points, gt_bboxes_3d, gt_labels_3d, gt_valid,
                          aggregated_points, coder, train_cfg, gt_per_seed,
                          mode='ca'):
    """Batched targets for CAVoteHead ('ca') / DeMFVoteHead ('demf').

    points (B, P, >=3), gt_bboxes_3d (B, G, 7) padded bottom-center boxes,
    gt_labels_3d (B, G), gt_valid (B, G) bool, aggregated_points (B, N, 3).
    Mode 'ca' takes half sizes from the coder and clips the distance
    targets (with a centerness); 'demf' takes full sizes and tests
    inside-ness against half of them.  Returns a dict of batched targets
    with the loss weights normalized over the whole batch.
    """
    gt_valid = gt_valid.bool()
    any_valid = gt_valid.any(1, keepdim=True)
    first_slot = torch.zeros_like(gt_valid)
    first_slot[:, 0] = True
    gt_valid = torch.where(any_valid, gt_valid, first_slot)
    gt_bboxes_3d = torch.where(gt_valid[..., None], gt_bboxes_3d,
                               gt_bboxes_3d.new_zeros(()))
    gt_labels_3d = torch.where(gt_valid, gt_labels_3d,
                               gt_labels_3d.new_zeros(()))

    vote_targets, vote_target_masks = _vote_targets(
        points[..., :3], gt_bboxes_3d, gt_valid, gt_per_seed)
    assign = _assign(gt_bboxes_3d, gt_labels_3d, gt_valid, aggregated_points,
                     coder, train_cfg['pos_distance_thr'],
                     train_cfg['neg_distance_thr'], mode == 'demf')
    if mode == 'ca':
        dist = assign['distance_targets'].clamp_min(0)
        assign['distance_targets'] = dist
        deltas = torch.stack([dist[..., 0:3], dist[..., 3:6]], -1)
        nom = deltas.amin(-1).prod(-1)
        den = deltas.amax(-1).prod(-1) + 1e-6
        assign['centerness_targets'] = ((nom / den + 1e-6) ** (1. / 3)).clamp(
            0., 1.)
    obj_w = assign['objectness_masks']
    assign['objectness_weights'] = obj_w / (global_sum(obj_w.sum()) + 1e-6)
    obj_t = assign['objectness_targets'].float()
    assign['box_loss_weights'] = obj_t / (global_sum(obj_t.sum()) + 1e-6)
    assign['vote_targets'] = vote_targets
    assign['vote_target_masks'] = vote_target_masks
    return assign
