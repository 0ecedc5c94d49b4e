"""Class-agnostic vote head (port of ``demf_tpu/models/vote_head.py``):
vote -> aggregate, the ``'ca'`` losses, and the fixed-shape multiclass 3D
NMS."""
from __future__ import annotations

import torch
from torch import nn

from ..core import boxes as box_ops
from ..ops.nms import aligned_3d_nms
from ..ops.sampling import furthest_point_sample
from ..registry import BBOX_CODERS, LOSSES, build_from_cfg
from .pointnet2 import PointSAModule
from .target_assign import get_vote_head_targets
from .vote_module import VoteModule


def multiclass_nms_3d(obj_scores, sem_scores, bbox3d, points, test_cfg):
    """Fixed-shape multiclass 3D NMS, batched over B.

    Args:
        obj_scores: (B, N) objectness probabilities.
        sem_scores: (B, N, C) semantic probabilities.
        bbox3d: (B, N, 7) gravity-center boxes.
        points: (B, P, >=3) input clouds (for the nonempty-box test).
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
    nonempty = torch.stack([
        box_ops.points_in_boxes(points[i, :, :3], bottom[i]).sum(0) > 5
        for i in range(b)])
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


class CAVoteHead(nn.Module):
    """Class-agnostic VoteNet head (reference CAVoteHead): the parts the
    DeMF head shares, and the face-distance losses of mode ``'ca'``."""

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
