"""DeMF-FCAF3D (port of ``demf_tpu/models/demf_fcaf3d.py``): the FCAF3D
detector, its top-K voxels across the levels taken as queries that
cross-attend into the frozen image branch's encoded levels at their boxes'
projected centres (the DeMF decoder layers, MSDA through kernels K3 / K4),
a refined prediction a decoder layer, and ``get_bboxes`` over the pools
that ``test_cfg['fusion_ensemble']`` names.

The image branch (ResNet-50 -> ChannelMapper -> deformable encoder) and its
feature cache are DeMF-VoteNet's (``models/demfnet.py``); a batch may carry
the branch's output as ``img_features``, and a frozen branch stays in eval
mode when the detector trains.  The loss: FCAF3D's on the levels, then one
set a fusion stage (suffix ``.f{i}``) on the base targets at the selected
voxels, all keys over the N + 1 stages.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.transforms import project_points_to_image
from ..registry import (BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg)
from ..utils.precision import dense
from .demfnet import IMG_BRANCH, DeMFVoteNet
from .fcaf3d import FCAF3DHead, concat_levels, take_rows, voxelize_batch
from .rpn_roi import topk_stable
from .transformer import (DeMFTransformerDecoderLayer, get_valid_ratios,
                          make_level_masks)

FUSION_ENSEMBLE_MODES = ('selected_base+fusion', 'fusion_only', 'all')


@HEADS.register_module()
class DeMFFcaf3DHead(FCAF3DHead):
    """FCAF3DHead + the DeMF deformable-fusion refinement stages."""

    def __init__(self, num_queries=256, embed_dims=256, decoder=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_queries = num_queries
        self.embed_dims = embed_dims
        self.has_decoder = decoder is not None
        dec = dict(decoder or {})
        num_layers = int(dec.pop('num_layers', 1))
        dec.pop('type', None)
        self.query_proj = nn.Linear(self.out_channels, embed_dims)
        self.decoder = nn.ModuleList(
            [DeMFTransformerDecoderLayer(**dec) for _ in range(num_layers)]
            if self.has_decoder else [])
        for i in range(len(self.decoder)):
            self.add_module(f'fuse_proj{i}',
                            nn.Linear(embed_dims, self.out_channels))
            self.add_module(f'conv_center{i + 1}',
                            nn.Linear(self.out_channels, 1, bias=False))
            self.add_module(f'conv_reg{i + 1}',
                            nn.Linear(self.out_channels, self.n_reg_outs,
                                      bias=False))
            self.add_module(f'conv_cls{i + 1}',
                            nn.Linear(self.out_channels, self.n_classes))

    def init_weights(self, generator):
        super().init_weights(generator)
        with torch.no_grad():
            for i in range(len(self.decoder)):
                getattr(self, f'conv_cls{i + 1}').bias.fill_(
                    -math.log((1 - 0.01) / 0.01))

    def forward(self, backbone_outs, img_dict=None, generator=None):
        head_outs = super().forward(backbone_outs)
        results = dict(head_outs=head_outs)
        if img_dict is None or not self.has_decoder:
            return results
        cat = concat_levels(head_outs, ('centerness', 'cls_scores',
                                        'features', 'points', 'bbox_pred',
                                        'valid'))
        score = torch.sigmoid(cat['cls_scores']).max(-1).values * \
            torch.sigmoid(cat['centerness'])
        score = torch.where(cat['valid'], score, torch.full_like(score, -1.0))
        k = min(self.num_queries, score.shape[1])
        _, sel = topk_stable(score, k)
        sel_feats = take_rows(cat['features'], sel)
        sel_points = take_rows(cat['points'], sel)
        sel_valid = cat['valid'].gather(1, sel)
        base_box = self.bbox_pred_to_bbox(sel_points,
                                          take_rows(cat['bbox_pred'], sel))

        mlvl_feats = img_dict['img_features']
        meta = img_dict['img_meta']
        spatial_shapes = tuple((f.shape[1], f.shape[2]) for f in mlvl_feats)
        batch_hw = (mlvl_feats[0].shape[1] * 8, mlvl_feats[0].shape[2] * 8)
        masks = make_level_masks(meta['img_shape'], batch_hw, spatial_shapes)
        valid_ratios = get_valid_ratios(masks)
        feat_flatten = torch.cat(
            [f.reshape(f.shape[0], -1, f.shape[-1]) for f in mlvl_feats], 1)
        mask_flatten = torch.cat([m.reshape(m.shape[0], -1) for m in masks],
                                 1)
        centers = torch.cat([base_box[..., :2],
                             base_box[..., 2:3] + base_box[..., 5:6] / 2], -1)
        reference_points = project_points_to_image(centers, meta)
        query = dense(sel_feats, self.query_proj)
        query_pos_input = torch.cat([centers, base_box[..., 3:6]],
                                    -1).detach()
        stages = []
        for i, layer in enumerate(self.decoder):
            query = layer(query, feat_flatten, query_pos_input, mask_flatten,
                          reference_points, spatial_shapes, valid_ratios,
                          generator)
            h = F.elu(dense(query, getattr(self, f'fuse_proj{i}')))
            reg = dense(h, getattr(self, f'conv_reg{i + 1}'))
            stages.append(dict(
                centerness=dense(h, getattr(self, f'conv_center{i + 1}'))[
                    ..., 0],
                bbox_pred=torch.cat([torch.exp(reg[..., :6]), reg[..., 6:]],
                                    -1),
                cls_scores=dense(h, getattr(self, f'conv_cls{i + 1}')),
                points=sel_points, valid=sel_valid))
        results['fusion_stages'] = stages
        results['sel_idx'] = sel
        return results

    def loss(self, results, gt_bboxes, gt_labels, gt_valid):
        """FCAF3D's loss on the levels and, for each fusion stage, the same
        terms (suffix ``.f{i}``) on the levels' targets at the selected
        voxels; every key over the N + 1 stages, as DeMF-VoteNet's head
        averages its stages."""
        cat, (cent_t, bbox_t, labels) = self.targets(
            results['head_outs'], gt_bboxes, gt_labels, gt_valid)
        losses = self.named_losses(cat, cent_t, bbox_t, labels)
        stages = results.get('fusion_stages', [])
        if not stages:
            return losses
        sel = results['sel_idx']
        sel_t = (cent_t.gather(1, sel), take_rows(bbox_t, sel),
                 labels.gather(1, sel))
        for i, st in enumerate(stages):
            losses.update(self.named_losses(st, *sel_t, suffix=f'.f{i}'))
        return {k: v / (len(stages) + 1) for k, v in losses.items()}

    def pools(self, results):
        """What ``get_bboxes`` draws candidates from, as
        ``test_cfg['fusion_ensemble']`` says: 'selected_base+fusion' (the
        default: the selected base voxels, the very proposals the fusion
        stages refine, beside the fusion stages), 'fusion_only', or 'all'
        (every base level beside the fusion stages)."""
        if 'fusion_stages' not in results:
            return results['head_outs']
        head_outs = results['head_outs']
        mode = str((self.test_cfg or {}).get('fusion_ensemble',
                                             'selected_base+fusion'))
        if mode not in FUSION_ENSEMBLE_MODES:
            raise ValueError(f'fusion_ensemble {mode!r}: one of '
                             f'{FUSION_ENSEMBLE_MODES}')
        sel = results.get('sel_idx')
        if mode == 'fusion_only':
            pools = []
        elif sel is not None and mode != 'all':
            cat = concat_levels(head_outs)
            pools = [{k: (v.gather(1, sel) if k == 'valid' else
                          take_rows(v, sel)) for k, v in cat.items()}]
        else:
            pools = list(head_outs)
        return pools + list(results['fusion_stages'])


@DETECTORS.register_module()
class DeMFFcaf3D(nn.Module):
    """FCAF3D + the frozen image branch + the deformable-fusion head.
    ``img_bbox_head`` is accepted and ignored (the deformdetr base config's
    2D head, which the fusion model does not use)."""

    synth_batch = ('demf_fcaf3d', 8, 16)

    def __init__(self, backbone=None, head=None, img_backbone=None,
                 img_neck=None, img_encoder=None, img_bbox_head=None,
                 freeze_img_branch=True, pretrained=None, init_cfg=None,
                 voxel_size=0.01, max_voxels=24576,
                 pc_start=(-3.2, -0.2, -2.0), train_cfg=None,
                 test_cfg=None):
        super().__init__()
        self.voxel_size = voxel_size
        self.max_voxels = max_voxels
        self.pc_start = tuple(pc_start)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.freeze_img_branch = freeze_img_branch
        self.backbone = build_from_cfg(backbone, BACKBONES)
        head = dict(head)
        head.setdefault('test_cfg', test_cfg)
        head.setdefault('pc_start', self.pc_start)
        self.head = build_from_cfg(head, HEADS)
        self.img_backbone = build_from_cfg(img_backbone, BACKBONES)
        self.img_neck = build_from_cfg(img_neck, NECKS)
        self.img_encoder = build_from_cfg(img_encoder, HEADS)
        if freeze_img_branch:
            for module in self._img_branch():
                module.requires_grad_(False)
        self.eval()

    # the image branch as DeMF-VoteNet has it: its features cached when
    # frozen, and a frozen branch kept in eval mode (norm_eval) in training
    caches_img_features = True
    _img_branch = DeMFVoteNet._img_branch
    extract_img_feat = DeMFVoteNet.extract_img_feat

    def train(self, mode=True):
        """Train mode everywhere but a frozen image branch."""
        nn.Module.train(self, mode)
        if self.freeze_img_branch:
            for module in self._img_branch():
                module.eval()
        return self

    def frozen_param_patterns(self):
        return list(IMG_BRANCH) if self.freeze_img_branch else []

    def forward(self, batch, generator=None):
        """batch: 'points' (B, P, >= 6), 'img_meta' and either 'img' (B, H,
        W, 3) or 'img_features' (the frozen image branch's NHWC levels)."""
        meta = batch['img_meta']
        if 'img_features' in batch:
            img_features = tuple(batch['img_features'])
        else:
            img_features = self.extract_img_feat(batch['img'],
                                                 meta['img_shape'])
        coords, feats, valid = voxelize_batch(
            batch['points'], self.voxel_size, self.pc_start, self.max_voxels)
        outs = self.backbone(coords, valid, feats)
        return self.head(outs, dict(img_features=img_features,
                                    img_meta=meta), generator)

    def loss(self, results, batch):
        return self.head.loss(results, batch['gt_bboxes_3d'],
                              batch['gt_labels_3d'], batch['gt_valid'])

    def get_bboxes(self, results, batch=None):
        return self.head.get_bboxes(self.head.pools(results))
