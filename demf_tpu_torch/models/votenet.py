"""VoteNet detector (port of ``demf_tpu/models/votenet.py``): the PointNet++
backbone and a vote head (``CAVoteHead`` in ``configs/baseline/votenet.py``,
the standard ``VoteHead`` in ``configs/_base_/models/votenet.py``), points
only: no image branch and no feature cache."""
from __future__ import annotations

from torch import nn

from ..registry import BACKBONES, DETECTORS, HEADS, build_from_cfg


@DETECTORS.register_module()
class VoteNet(nn.Module):
    """``bbox_head`` gets the detector's ``train_cfg`` / ``test_cfg``, as in
    the JAX package.  ``loss`` and ``get_bboxes`` are the head's."""

    # what the step-time measurements train it on (``zoo.synth_batch_for``):
    # batch maker, scenes, GT slots
    synth_batch = ('points', 16, 64)

    def __init__(self, backbone=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, pretrained=None, init_cfg=None):
        super().__init__()
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.backbone = build_from_cfg(backbone, BACKBONES)
        head = dict(bbox_head)
        head['train_cfg'] = train_cfg
        head['test_cfg'] = test_cfg
        self.bbox_head = build_from_cfg(head, HEADS)

    def frozen_param_patterns(self):
        """Nothing is frozen."""
        return []

    def forward(self, batch, sample_mod=None, generator=None):
        """batch: 'points' (B, N, C) (other keys are not read);
        ``sample_mod`` overrides the train or test config's proposal
        sampling; ``generator`` draws the 'random' samples."""
        x = self.backbone(batch['points'])
        feat_dict = dict(seed_points=x['fp_xyz'][-1],
                         seed_features=x['fp_features'][-1],
                         seed_indices=x['fp_indices'][-1])
        if sample_mod is None:
            cfg = self.train_cfg if self.training else self.test_cfg
            sample_mod = cfg['sample_mod']
        return self.bbox_head(feat_dict, sample_mod, generator)

    def loss(self, results, batch):
        return self.bbox_head.loss(
            results, batch['points'], batch['gt_bboxes_3d'],
            batch['gt_labels_3d'], batch['gt_valid'])

    def get_bboxes(self, results, batch):
        return self.bbox_head.get_bboxes(batch['points'], results)
