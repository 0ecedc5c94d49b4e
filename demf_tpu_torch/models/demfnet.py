"""DeMFVoteNet detector (port of ``demf_tpu/models/demfnet.py``): image
branch (ResNet-50 -> ChannelMapper -> deformable encoder), PointNet++ point
branch, DeMF fusion head, and the loss of the stage-2 training step.

With ``freeze_img_branch`` the image branch has ``requires_grad=False``,
stays in eval mode under ``model.train()`` and runs without a graph; a
batch may instead carry its output as ``img_features``
(``engine/feature_cache.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..registry import (BACKBONES, DETECTORS, HEADS, NECKS,
                        build_from_cfg)

IMG_BRANCH = ('img_backbone', 'img_neck', 'img_encoder')


@DETECTORS.register_module()
class DeMFVoteNet(nn.Module):
    """``img_bbox_head`` is accepted and ignored: the DeMF config inherits
    the Deformable-DETR base whose 2D head DeMF does not use."""

    # what the step-time measurements train it on (``zoo.synth_batch_for``):
    # batch maker, scenes, GT slots
    synth_batch = ('demf', 16, 64)
    # a batch may carry the frozen image branch's output as ``img_features``
    # (``engine/feature_cache.py``)
    caches_img_features = True

    def __init__(self, pts_backbone=None, pts_bbox_head=None, pts_neck=None,
                 img_backbone=None, img_neck=None, img_encoder=None,
                 img_bbox_head=None, freeze_img_branch=False,
                 num_sampled_seed=None, train_cfg=None, test_cfg=None,
                 pretrained=None, init_cfg=None):
        super().__init__()
        if pts_neck is not None:
            raise NotImplementedError('pts_neck is not part of DeMF')
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.freeze_img_branch = freeze_img_branch
        self.pts_backbone = build_from_cfg(pts_backbone, BACKBONES)
        head = dict(pts_bbox_head)
        head['train_cfg'] = (train_cfg or {}).get('pts')
        head['test_cfg'] = (test_cfg or {}).get('pts')
        self.pts_bbox_head = build_from_cfg(head, HEADS)
        self.img_backbone = build_from_cfg(img_backbone, BACKBONES)
        self.img_neck = build_from_cfg(img_neck, NECKS)
        self.img_encoder = build_from_cfg(img_encoder, HEADS)
        if freeze_img_branch:
            for module in self._img_branch():
                module.requires_grad_(False)

    def _img_branch(self):
        return [m for m in (getattr(self, n) for n in IMG_BRANCH)
                if m is not None]

    def train(self, mode=True):
        """Train mode everywhere but a frozen image branch."""
        super().train(mode)
        if self.freeze_img_branch:
            for module in self._img_branch():
                module.eval()
        return self

    def frozen_param_patterns(self):
        """Parameter-name substrings the optimizer keeps still (lr_mult 0)
        when the image branch is frozen."""
        return list(IMG_BRANCH) if self.freeze_img_branch else []

    def extract_img_feat(self, img, img_shape):
        """img (B, H, W, 3) -> tuple of encoded NHWC feature maps."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and
                                    not self.freeze_img_branch):
            x = self.img_backbone(img)
            if self.img_neck is not None:
                x = self.img_neck(x)
            if self.img_encoder is not None:
                x = self.img_encoder(x, img_shape)
        return x

    def forward(self, batch, sample_mod=None, generator=None):
        """batch: 'points' (B, N, C), 'img_meta' (dict of batched tensors)
        and either 'img' (B, H, W, 3) or 'img_features' (tuple of NHWC maps
        from the frozen image branch).  ``sample_mod`` overrides the train
        or test config's proposal sampling; ``generator`` (a
        ``torch.Generator`` on the model's device) draws the dropout masks
        and random samples in train mode."""
        meta = batch['img_meta']
        if 'img_features' in batch:
            img_features = tuple(batch['img_features'])
        else:
            img_features = self.extract_img_feat(batch['img'],
                                                 meta['img_shape'])
        x = self.pts_backbone(batch['points'])
        feat_dict = dict(seed_points=x['fp_xyz'][-1],
                         seed_features=x['fp_features'][-1],
                         seed_indices=x['fp_indices'][-1])
        if sample_mod is None:
            cfg = self.train_cfg if self.training else self.test_cfg
            sample_mod = cfg['pts']['sample_mod']
        return self.pts_bbox_head(
            feat_dict, sample_mod,
            dict(img_features=img_features, img_meta=meta), generator)

    def loss(self, results, batch):
        return self.pts_bbox_head.loss(
            results, batch['points'], batch['gt_bboxes_3d'],
            batch['gt_labels_3d'], batch['gt_valid'])

    def get_bboxes(self, results, batch):
        return self.pts_bbox_head.get_bboxes(batch['points'], results)
