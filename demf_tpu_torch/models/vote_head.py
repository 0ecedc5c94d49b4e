"""Vote heads (port of ``demf_tpu/models/vote_head.py``): the
class-agnostic ``CAVoteHead`` (vote -> aggregate -> its ``conv_pred`` ->
the codec's fields, the ``'ca'`` losses), the standard VoteNet
``VoteHead``, and the fixed-shape multiclass 3D NMS."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import boxes as box_ops
from ..ops.box_count import box_point_count
from ..ops.nms import aligned_3d_nms
from ..ops.sampling import furthest_point_sample
from ..parallel import global_sum
from ..registry import BBOX_CODERS, HEADS, LOSSES, build_from_cfg
from .conv_bbox_head import BaseConvBboxHead
from .losses import chamfer_distance
from .pointnet2 import PointSAModule
from .target_assign import _take, _vote_targets, get_vote_head_targets
from .vote_module import VoteModule


def multiclass_nms_3d(obj_scores, sem_scores, bbox3d, points, test_cfg):
    """Fixed-shape multiclass 3D NMS, batched over B.

    Args:
        obj_scores: (B, N) objectness probabilities.
        sem_scores: (B, N, C) semantic probabilities.
        bbox3d: (B, N, 7) gravity-center boxes.
        points: (B, P, >=3) input clouds (for the nonempty-box test: more
            than 5 points inside, counted for the batch by K9 on the card).
        test_cfg: dict with nms_thr / score_thr / per_class_proposal.
    Returns:
        dict of padded results: boxes_3d (B, K, 7), scores_3d (B, K),
        labels_3d (B, K), valid (B, K), K = N * C with per-class proposals
        and N without.
    """
    b, n, c = sem_scores.shape
    bottom = torch.cat([bbox3d[..., :2],
                        bbox3d[..., 2:3] - bbox3d[..., 5:6] / 2.,
                        bbox3d[..., 3:]], -1)
    nonempty = box_point_count(points, bottom) > 5
    minmax = box_ops.corners_minmax(bottom.reshape(b * n, 7)).reshape(b, n, 6)
    classes = torch.argmax(sem_scores, -1)
    keep = aligned_3d_nms(minmax, obj_scores, classes, test_cfg['nms_thr'],
                          valid=nonempty)
    selected = keep & (obj_scores > test_cfg['score_thr'])
    if test_cfg.get('per_class_proposal', False):
        boxes = bbox3d.repeat(1, c, 1)
        scores = (obj_scores[:, None, :] * sem_scores.transpose(1, 2)
                  ).reshape(b, c * n)
        labels = torch.arange(c, device=bbox3d.device).repeat_interleave(
            n).expand(b, -1)
        valid = selected.repeat(1, c)
    else:
        boxes = bbox3d
        scores = obj_scores * torch.gather(sem_scores, -1,
                                           classes[..., None])[..., 0]
        labels = classes
        valid = selected
    return dict(boxes_3d=boxes, scores_3d=scores, labels_3d=labels,
                valid=valid)


@HEADS.register_module()
class CAVoteHead(nn.Module):
    """Class-agnostic VoteNet head (reference CAVoteHead): vote, aggregate,
    one ``conv_pred`` (``BaseConvBboxHead``) and the codec's
    ``split_pred``; the face-distance losses of mode ``'ca'``.  The DeMF
    head shares its vote and aggregation and has prediction stages of its
    own (``_build_conv_pred``)."""

    def __init__(self, num_classes=10, bbox_coder=None, train_cfg=None,
                 test_cfg=None, vote_module_cfg=None,
                 vote_aggregation_cfg=None, pred_layer_cfg=None,
                 conv_cfg=None, norm_cfg=None, **loss_cfgs):
        super().__init__()
        self.num_classes = num_classes
        self.bbox_coder_cfg = dict(bbox_coder)
        self.coder = build_from_cfg(self.bbox_coder_cfg, BBOX_CODERS)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.pred_layer_cfg = dict(pred_layer_cfg or {})
        self.loss_cfgs = loss_cfgs
        self.vote_module = VoteModule(**vote_module_cfg)
        agg = dict(vote_aggregation_cfg)
        agg.pop('type', None)
        self.num_proposal = agg['num_point']
        self.vote_aggregation = PointSAModule(
            list(agg['mlp_channels']), num_point=agg['num_point'],
            radius=agg['radius'], num_sample=agg['num_sample'],
            use_xyz=agg.get('use_xyz', True),
            normalize_xyz=agg.get('normalize_xyz', False))
        self._build_conv_pred()

    def _build_conv_pred(self):
        self.conv_pred = BaseConvBboxHead(
            **self.pred_layer_cfg,
            num_cls_out_channels=self._cls_out_channels(),
            num_reg_out_channels=self._reg_out_channels())

    @property
    def with_semantic(self):
        return self.loss_cfgs.get('semantic_loss') is not None

    def _cls_out_channels(self):
        return self.num_classes + 2 if self.with_semantic else 2

    def _reg_out_channels(self):
        return 6 + self.bbox_coder_cfg['num_dir_bins'] * 2

    def build_loss(self, name):
        """The configured loss ``name`` (e.g. ``'objectness_loss'``)."""
        return build_from_cfg(self.loss_cfgs[name], LOSSES)

    def _vote_and_aggregate(self, feat_dict, sample_mod, generator=None):
        """Vote, then aggregate proposals around the FPS of the votes
        ('vote'), of the seeds ('seed'), seeds drawn at random from
        ``generator`` ('random'), or around every vote from the seed
        features ('spec')."""
        seed_points = feat_dict['seed_points']
        vote_points, vote_features, vote_offset = self.vote_module(
            seed_points, feat_dict['seed_features'])
        results = dict(seed_points=seed_points,
                       seed_indices=feat_dict['seed_indices'],
                       vote_points=vote_points, vote_features=vote_features,
                       vote_offset=vote_offset)
        if sample_mod == 'vote':
            new_xyz, feats, _ = self.vote_aggregation(vote_points,
                                                      vote_features)
        elif sample_mod in ('seed', 'random'):
            if sample_mod == 'seed':
                idx = furthest_point_sample(seed_points, self.num_proposal)
            elif generator is None:
                raise ValueError("sample_mod 'random' needs a "
                                 "torch.Generator")
            else:
                b, n = seed_points.shape[:2]
                idx = torch.randint(0, n, (b, self.num_proposal),
                                    generator=generator,
                                    device=seed_points.device)
            new_xyz, feats, _ = self.vote_aggregation(
                vote_points, vote_features, indices=idx)
        elif sample_mod == 'spec':
            new_xyz, feats, _ = self.vote_aggregation(
                seed_points, feat_dict['seed_features'],
                target_xyz=vote_points)
        else:
            raise NotImplementedError(f'sample_mod {sample_mod!r}')
        results['aggregated_points'] = new_xyz
        return results, feats

    def forward(self, feat_dict, sample_mod, generator=None):
        """feat_dict: seed_points / features / indices of the backbone ->
        the results dict: the vote module's and aggregation's outputs and
        the codec's fields of ``conv_pred``'s prediction."""
        results, feats = self._vote_and_aggregate(feat_dict, sample_mod,
                                                  generator)
        cls, reg = self.conv_pred(feats)
        results.update(self.coder.split_pred(
            cls.transpose(1, 2), reg.transpose(1, 2),
            results['aggregated_points']))
        return results

    def get_bboxes(self, points, results):
        """Softmax scores and decoded boxes, then multiclass 3D NMS."""
        return multiclass_nms_3d(results['obj_scores'].softmax(-1)[..., -1],
                                 results['sem_scores'].softmax(-1),
                                 self.coder.decode(results), points,
                                 self.test_cfg)

    def loss(self, results, points, gt_bboxes_3d, gt_labels_3d, gt_valid):
        """Reference CAVoteHead.loss over a results dict with the
        ``ClassAgnosticBBoxCoder`` fields (distance, dir_class,
        dir_res_norm, obj_scores, sem_scores, ref_points)."""
        targets = get_vote_head_targets(
            points, gt_bboxes_3d, gt_labels_3d, gt_valid,
            results['aggregated_points'], self.coder, self.train_cfg,
            self.vote_module.gt_per_seed, mode='ca')
        losses = dict(vote_loss=self.vote_module.get_loss(
            results['seed_points'], results['vote_points'],
            results['seed_indices'], targets['vote_target_masks'],
            targets['vote_targets']))
        losses['objectness_loss'] = self.build_loss('objectness_loss')(
            results['obj_scores'], targets['objectness_targets'],
            weight=targets['objectness_weights'])
        blw = targets['box_loss_weights']
        losses['size_res_loss'] = self.build_loss('size_res_loss')(
            results['distance'], targets['distance_targets'],
            weight=blw[..., None])
        dir_cls = targets['dir_class_targets']
        losses['dir_class_loss'] = self.build_loss('dir_class_loss')(
            results['dir_class'], dir_cls, weight=blw)
        dir_res_norm = torch.gather(results['dir_res_norm'], -1,
                                    dir_cls[..., None])[..., 0]
        losses['dir_res_loss'] = self.build_loss('dir_res_loss')(
            dir_res_norm, targets['dir_res_targets'], weight=blw)
        if self.with_semantic:
            losses['semantic_loss'] = self.build_loss('semantic_loss')(
                results['sem_scores'], targets['mask_targets'], weight=blw)
        if self.loss_cfgs.get('iou_loss') is not None:
            corners_pred = self.coder.decode_corners(results['distance'],
                                                     results['ref_points'])
            corners_target = self.coder.decode_corners(
                targets['distance_targets'], results['ref_points'])
            losses['iou_loss'] = self.build_loss('iou_loss')(
                corners_pred, corners_target, weight=blw)
        return losses


@HEADS.register_module()
class VoteHead(CAVoteHead):
    """Standard VoteNet head (mmdet3d ``VoteHead``) with the
    ``PartialBinBasedBBoxCoder``: per-class mean-size regression, the
    chamfer center loss both ways, size class and normalized size residual
    losses, and objectness by distance only (no inside-box test).  A scene
    without GT gets one zero box of label 0 in its first slot."""

    def _cls_out_channels(self):
        return self.num_classes + 2

    def _reg_out_channels(self):
        nb = self.bbox_coder_cfg['num_dir_bins']
        return 3 + nb * 2 + self.bbox_coder_cfg['num_sizes'] * 4

    def loss(self, results, points, gt_bboxes_3d, gt_labels_3d, gt_valid):
        coder = self.coder
        tcfg = self.train_cfg
        agg = results['aggregated_points']
        # the fake box of a scene without GT (reference :764-778)
        any_valid = gt_valid.any(1, keepdim=True)
        first = torch.zeros_like(gt_valid)
        first[:, 0] = True
        gt_valid = torch.where(any_valid, gt_valid, first)
        gt_bboxes_3d = torch.where(gt_valid[..., None], gt_bboxes_3d, 0.0)
        gt_labels_3d = torch.where(gt_valid, gt_labels_3d, 0)

        vote_targets, vote_target_masks = _vote_targets(
            points[..., :3], gt_bboxes_3d, gt_valid,
            self.vote_module.gt_per_seed)
        center_t, size_cls_t, size_res_t, dir_cls_t, dir_res_t = \
            coder.encode(gt_bboxes_3d, gt_labels_3d)

        d2 = ((agg[:, :, None] - center_t[:, None]) ** 2).sum(-1)
        d2 = torch.where(gt_valid[:, None, :], d2, d2.new_tensor(1e10))
        min_d2, assignment = d2.min(-1)
        euclid = torch.sqrt(min_d2 + 1e-6)
        positive = euclid < tcfg['pos_distance_thr']
        obj_targets = positive.long()
        obj_masks = (positive | (euclid > tcfg['neg_distance_thr'])).float()
        obj_w = obj_masks / (global_sum(obj_masks.sum()) + 1e-6)
        blw = positive.float()
        blw = blw / (global_sum(blw.sum()) + 1e-6)

        size_cls_a = _take(size_cls_t, assignment)
        size_res_a = _take(size_res_t, assignment)
        dir_cls_a = _take(dir_cls_t, assignment)
        dir_res_a = _take(dir_res_t, assignment) / (np.pi /
                                                    coder.num_dir_bins)
        mask_targets = _take(gt_labels_3d, assignment)

        losses = dict(vote_loss=self.vote_module.get_loss(
            results['seed_points'], results['vote_points'],
            results['seed_indices'], vote_target_masks, vote_targets))
        losses['objectness_loss'] = self.build_loss('objectness_loss')(
            results['obj_scores'], obj_targets, weight=obj_w)
        # the chamfer center loss, both ways
        valid_w = gt_valid.float()
        valid_w = valid_w / (global_sum(valid_w.sum()) + 1e-6)
        ccfg = dict(self.loss_cfgs['center_loss'])
        src2dst, dst2src, _, _ = chamfer_distance(
            results['center'], center_t, mode=ccfg.get('mode', 'l2'),
            dst_valid=gt_valid)
        losses['center_loss'] = (
            (src2dst * blw).sum() * ccfg.get('loss_src_weight', 1.0) +
            (torch.where(gt_valid, dst2src, 0.0) * valid_w).sum() *
            ccfg.get('loss_dst_weight', 1.0))
        losses['dir_class_loss'] = self.build_loss('dir_class_loss')(
            results['dir_class'], dir_cls_a, weight=blw)
        dir_res_norm = torch.gather(results['dir_res_norm'], -1,
                                    dir_cls_a[..., None])[..., 0]
        losses['dir_res_loss'] = self.build_loss('dir_res_loss')(
            dir_res_norm, dir_res_a, weight=blw)
        losses['size_class_loss'] = self.build_loss('size_class_loss')(
            results['size_class'], size_cls_a, weight=blw)
        size_res_norm = torch.gather(
            results['size_res_norm'], -2,
            size_cls_a[..., None, None].expand(
                size_cls_a.shape + (1, 3)))[..., 0, :]
        mean = torch.as_tensor(coder.mean_sizes,
                               device=agg.device)[size_cls_a]
        losses['size_res_loss'] = self.build_loss('size_res_loss')(
            size_res_norm, size_res_a / mean.clamp_min(1e-6),
            weight=blw[..., None])
        losses['semantic_loss'] = self.build_loss('semantic_loss')(
            results['sem_scores'], mask_targets, weight=blw)
        return losses
