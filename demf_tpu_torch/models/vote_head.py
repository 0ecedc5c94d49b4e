"""Class-agnostic vote head, inference half (port of
``demf_tpu/models/vote_head.py``): vote -> aggregate, and the fixed-shape
multiclass 3D NMS.  The losses arrive with the training path."""
from __future__ import annotations

import torch
from torch import nn

from ..core import boxes as box_ops
from ..ops.nms import aligned_3d_nms
from ..ops.sampling import furthest_point_sample
from ..registry import BBOX_CODERS, build_from_cfg
from .pointnet2 import PointSAModule
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
    DeMF head shares.  Loss configs are kept for the training path."""

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

    def _vote_and_aggregate(self, feat_dict, sample_mod):
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
        elif sample_mod == 'seed':
            idx = furthest_point_sample(seed_points, self.num_proposal)
            new_xyz, feats, _ = self.vote_aggregation(
                vote_points, vote_features, indices=idx)
        else:
            raise NotImplementedError(
                f'sample_mod {sample_mod!r}: the port has seed and vote')
        results['aggregated_points'] = new_xyz
        return results, feats
