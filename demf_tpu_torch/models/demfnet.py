"""DeMFVoteNet detector, inference (port of
``demf_tpu/models/demfnet.py``): frozen image branch (ResNet-50 ->
ChannelMapper -> deformable encoder), PointNet++ point branch, DeMF fusion
head."""
from __future__ import annotations

from torch import nn

from ..registry import (BACKBONES, DETECTORS, HEADS, NECKS,
                        build_from_cfg)


@DETECTORS.register_module()
class DeMFVoteNet(nn.Module):
    """``img_bbox_head`` is accepted and ignored: the DeMF config inherits
    the Deformable-DETR base whose 2D head DeMF does not use."""

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
        self.pts_backbone = build_from_cfg(pts_backbone, BACKBONES)
        head = dict(pts_bbox_head)
        head['train_cfg'] = (train_cfg or {}).get('pts')
        head['test_cfg'] = (test_cfg or {}).get('pts')
        self.pts_bbox_head = build_from_cfg(head, HEADS)
        self.img_backbone = build_from_cfg(img_backbone, BACKBONES)
        self.img_neck = build_from_cfg(img_neck, NECKS)
        self.img_encoder = build_from_cfg(img_encoder, HEADS)

    def extract_img_feat(self, img, img_shape):
        """img (B, H, W, 3) -> tuple of encoded NHWC feature maps."""
        x = self.img_backbone(img)
        if self.img_neck is not None:
            x = self.img_neck(x)
        if self.img_encoder is not None:
            x = self.img_encoder(x, img_shape)
        return x

    def forward(self, batch, sample_mod=None):
        """batch: 'points' (B, N, C), 'img_meta' (dict of batched tensors)
        and either 'img' (B, H, W, 3) or 'img_features' (tuple of NHWC maps
        from the frozen image branch).  ``sample_mod`` overrides the test
        config's proposal sampling ('seed' or 'vote').  Inference only."""
        if self.training:
            raise NotImplementedError('DeMFVoteNet runs inference only; call '
                                      '.eval() (training is not ported yet)')
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
            sample_mod = self.test_cfg['pts']['sample_mod']
        return self.pts_bbox_head(
            feat_dict, sample_mod,
            dict(img_features=img_features, img_meta=meta))

    def get_bboxes(self, results, batch):
        return self.pts_bbox_head.get_bboxes(batch['points'], results)
