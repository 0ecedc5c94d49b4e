"""ImVoteNet with the Deformable-DETR image branch, in its image-only mode:
the stage-1 2D pretrain (port of ``demf_tpu/models/imvotenet.py::
ImVoteNet_Deformdetr``).

A batch without ``points`` runs ResNet-50 -> ChannelMapper ->
``DeformableDETRHead`` and trains all three end to end (but for the
backbone's ``frozen_stages``); its checkpoint is what stage 2 warm-starts
its image branch from (``engine.checkpoint.load_weights``).  The fusion
mode (a batch with ``points``: VoteFusion and the three vote towers) is
not ported yet; like the JAX package, the module builds only what the
image-only mode runs and accepts the fusion mode's config keys unread.
"""
from __future__ import annotations

import torch
from torch import nn

from ..registry import BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg

IMG_BRANCH = ('img_backbone', 'img_neck', 'img_bbox_head')


@DETECTORS.register_module()
class ImVoteNet_Deformdetr(nn.Module):
    # what the step-time measurements train it on (``zoo.synth_batch_for``):
    # batch maker, images, GT slots
    synth_batch = ('detr2d', 4, 20)

    def __init__(self, pts_backbone=None, pts_bbox_heads=None, pts_neck=None,
                 img_backbone=None, img_neck=None, img_bbox_head=None,
                 img_mlp=None, freeze_img_branch=False, fusion_layer=None,
                 num_sampled_seed=None, train_cfg=None, test_cfg=None,
                 pretrained=None, init_cfg=None):
        super().__init__()
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.freeze_img_branch = freeze_img_branch
        self.img_backbone = build_from_cfg(img_backbone, BACKBONES)
        self.img_neck = build_from_cfg(img_neck, NECKS)
        head = dict(img_bbox_head)
        head['train_cfg'] = train_cfg
        head['test_cfg'] = test_cfg
        self.img_bbox_head = build_from_cfg(head, HEADS)
        if freeze_img_branch:
            for name in IMG_BRANCH:
                if getattr(self, name) is not None:
                    getattr(self, name).requires_grad_(False)

    def train(self, mode=True):
        """Train mode everywhere but a frozen image branch."""
        super().train(mode)
        if self.freeze_img_branch:
            for name in IMG_BRANCH:
                if getattr(self, name) is not None:
                    getattr(self, name).eval()
        return self

    def frozen_param_patterns(self):
        return list(IMG_BRANCH) if self.freeze_img_branch else []

    def extract_img_feat(self, img):
        """img (B, H, W, 3) -> tuple of NHWC maps from the neck."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and
                                    not self.freeze_img_branch):
            x = self.img_backbone(img)
            if self.img_neck is not None:
                x = self.img_neck(x)
        return x

    def forward(self, batch, sample_mod=None, generator=None):
        """batch: ``img`` (B, H, W, 3) and ``img_meta['img_shape']`` (B, 2);
        -> dict(img_preds=the head's output).  ``generator`` draws the
        dropout masks in train mode."""
        if 'points' in batch:
            raise NotImplementedError('fusion mode: ROADMAP M5')
        feats = self.extract_img_feat(batch['img'])
        return dict(img_preds=self.img_bbox_head(
            feats, batch['img_meta']['img_shape'], generator))

    def loss(self, results, batch):
        return self.img_bbox_head.loss(
            results['img_preds'], batch['gt_bboxes'], batch['gt_labels'],
            batch['gt_bboxes_valid'], batch['img_meta']['img_shape'])

    def get_bboxes(self, results, batch):
        return self.img_bbox_head.get_bboxes(
            results['img_preds'], batch['img_meta']['img_shape'])
