"""Deformable-DETR 2D detection head: the stage-1 image-branch pretrain
(port of ``demf_tpu/models/detr_head.py``).

mmdet's ``DeformableDETRHead`` + ``DeformableDetrTransformer`` as the
reference configures them (configs/deformdetr/imvotenet_deform.py): 300
learned queries, a 6-layer MSDA encoder and a 6-layer decoder with shared
prediction branches (no two-stage, no box refine), focal classification,
L1 + GIoU box losses over every decoder layer, one-to-one assignment.

GT is padded to a fixed count with a validity mask.  The assignment of all
decoder layers and images is solved in one batch: on the device by the
auction of ``ops/assignment.py`` (the default, as in the JAX package), or
with ``assigner.solver='scipy'`` by the Hungarian solve on the host, one
copy a step.  Parameter names follow mmdet where the stage-2 hand-over
reads them (``transformer.encoder.layers``, ``transformer.level_embeds``);
the shared branches are ``fc_cls`` and ``fc_reg``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.assignment import auction_match, hungarian_match
from ..registry import HEADS, LOSSES, build_from_cfg
from ..utils.precision import dense
from .losses import extent_area
from .rpn_roi import topk_stable
from .transformer import (DetrTransformerDecoderLayer, _Layers,
                          build_encoder_layers, encode_levels, sine_encoding)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def giou_2d(a, b):
    """GIoU matrix between (..., N, 4) and (..., M, 4) xyxy boxes:
    (..., N, M)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    inter = extent_area(torch.minimum(a[..., 2:], b[..., 2:]) -
                        torch.maximum(a[..., :2], b[..., :2]))
    union = extent_area(a[..., 2:] - a[..., :2]) + \
        extent_area(b[..., 2:] - b[..., :2]) - inter
    iou = inter / union.clamp_min(1e-7)
    enclose = extent_area(torch.maximum(a[..., 2:], b[..., 2:]) -
                          torch.minimum(a[..., :2], b[..., :2]))
    return iou - (enclose - union) / enclose.clamp_min(1e-7)


def _whwh(img_shape):
    """(B, 2) valid [h, w] -> (B, 4) float [w, h, w, h]."""
    h, w = img_shape[:, 0], img_shape[:, 1]
    return torch.stack([w, h, w, h], -1).float()


class DetrMLP(nn.Sequential):
    """Linear + ReLU ... Linear: the box branch (indices 0, 2, 4)."""

    def __init__(self, in_channels=256, hidden=256, out=4, layers=3):
        mods = []
        for i in range(layers - 1):
            mods += [nn.Linear(in_channels if i == 0 else hidden, hidden),
                     nn.ReLU()]
        mods.append(nn.Linear(hidden if layers > 1 else in_channels, out))
        super().__init__(*mods)

    def forward(self, x):
        linears = [m for m in self if isinstance(m, nn.Linear)]
        for lin in linears[:-1]:
            x = torch.relu(dense(x, lin))
        return dense(x, linears[-1])


class DeformableDetrTransformer(nn.Module):
    """The parameters mmdet keeps under ``transformer``: encoder and
    decoder layers, level embeds, and the reference point projection."""

    def __init__(self, encoder, decoder, num_levels, embed_dims):
        super().__init__()
        self.encoder = _Layers(build_encoder_layers(encoder, num_levels,
                                                    embed_dims))
        tl = dict(decoder.get('transformerlayers', {}))
        attn_cfgs = tl.get('attn_cfgs', [{}, {}])
        self_cfg, cross = dict(attn_cfgs[0]), dict(attn_cfgs[1])
        self.decoder = _Layers([DetrTransformerDecoderLayer(
            embed_dims, cross.get('num_heads', 8), num_levels,
            cross.get('num_points', 4), tl.get('feedforward_channels', 1024),
            tl.get('ffn_dropout', 0.1), self_cfg.get('dropout', 0.1),
            cross.get('dropout', 0.1))
            for _ in range(decoder.get('num_layers', 6))])
        self.level_embeds = nn.Parameter(torch.zeros(num_levels, embed_dims))
        self.reference_points = nn.Linear(embed_dims, 2)


@HEADS.register_module()
class DeformableDETRHead(nn.Module):
    def __init__(self, num_query=300, num_classes=10, in_channels=2048,
                 embed_dims=256, sync_cls_avg_factor=True,
                 as_two_stage=False, with_box_refine=False, transformer=None,
                 positional_encoding=None, loss_cls=None, loss_bbox=None,
                 loss_iou=None, train_cfg=None, test_cfg=None,
                 num_feature_levels=4):
        super().__init__()
        if as_two_stage or with_box_refine:
            raise NotImplementedError('the port has the one-stage head '
                                      'without box refine')
        t = dict(transformer or {})
        self.num_query = num_query
        self.num_classes = num_classes
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.pos_enc = sine_encoding(positional_encoding)
        self.transformer = DeformableDetrTransformer(
            dict(t.get('encoder', {})), dict(t.get('decoder', {})),
            num_feature_levels, embed_dims)
        self.query_embedding = nn.Embedding(num_query, 2 * embed_dims)
        self.fc_cls = nn.Linear(embed_dims, num_classes)
        self.fc_reg = DetrMLP(embed_dims, embed_dims, 4, 3)
        self.loss_cls = build_from_cfg(loss_cls, LOSSES)
        self.loss_bbox = build_from_cfg(loss_bbox, LOSSES)
        self.loss_iou = build_from_cfg(loss_iou, LOSSES)

    @torch.no_grad()
    def init_weights(self, generator):
        """Standard normal queries; the class bias at a prior of 0.01."""
        w = self.query_embedding.weight
        w.copy_(torch.randn(w.shape, generator=generator))
        self.fc_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, mlvl_feats, img_shape, generator=None):
        """mlvl_feats: tuple of NHWC maps (4 levels); img_shape (B, 2)
        valid [h, w] at input resolution.  -> dict: ``cls_scores``
        (L_dec, B, Q, C), ``bbox_preds`` (L_dec, B, Q, 4) normalized
        cxcywh."""
        t = self.transformer
        memory, key_padding_mask, spatial_shapes, valid_ratios = \
            encode_levels(t.encoder.layers, mlvl_feats, img_shape,
                          self.pos_enc, t.level_embeds, generator)
        b = memory.shape[0]
        # the learned queries: the embedding splits into (query_pos, query)
        query_pos, query = self.query_embedding.weight.chunk(2, -1)
        query_pos = query_pos[None].expand(b, -1, -1)
        query = query[None].expand(b, -1, -1)
        reference_points = dense(query_pos, t.reference_points).sigmoid()
        ref_input = reference_points[:, :, None, :] * valid_ratios[:, None]
        ref_logit = inverse_sigmoid(reference_points)
        cls_all, bbox_all = [], []
        for layer in t.decoder.layers:
            query = layer(query, memory, query_pos, key_padding_mask,
                          ref_input, spatial_shapes, generator)
            cls_all.append(dense(query, self.fc_cls))
            tmp = self.fc_reg(query)
            bbox_all.append(torch.cat(
                [tmp[..., :2] + ref_logit, tmp[..., 2:]], -1).sigmoid())
        return dict(cls_scores=torch.stack(cls_all),
                    bbox_preds=torch.stack(bbox_all))

    # -- training --------------------------------------------------------
    def match_cost(self, cls, bbox, gt_cxcywh, gt_labels, gt_valid, factor):
        """The assigner's cost for every layer and image at once: cls
        (L, B, Q, C), bbox (L, B, Q, 4) -> (L, B, Q, G); padding gt columns
        cost 1e6."""
        assigner = dict(dict(self.train_cfg or {}).get('assigner', {}))
        cls_w = dict(assigner.get('cls_cost', {})).get('weight', 1.0)
        reg_w = dict(assigner.get('reg_cost', {})).get('weight', 1.0)
        iou_w = dict(assigner.get('iou_cost', {})).get('weight', 1.0)
        # focal classification cost (mmdet FocalLossCost)
        prob = cls.sigmoid()
        alpha, gamma, eps = 0.25, 2.0, 1e-12
        neg = (1 - alpha) * prob ** gamma * -(1 - prob + eps).log()
        pos = alpha * (1 - prob) ** gamma * -(prob + eps).log()
        labels = gt_labels.long()[None, :, None, :].expand(
            cls.shape[0], -1, cls.shape[2], -1)
        cls_cost = (pos - neg).gather(-1, labels)
        reg_cost = (bbox[..., :, None, :] -
                    gt_cxcywh[None, :, None, :, :]).abs().sum(-1)
        whwh = factor[None, :, None, :]
        iou_cost = -giou_2d(box_cxcywh_to_xyxy(bbox) * whwh,
                            (box_cxcywh_to_xyxy(gt_cxcywh) *
                             factor[:, None])[None])
        cost = cls_w * cls_cost + reg_w * reg_cost + iou_w * iou_cost
        return torch.where(gt_valid[None, :, None, :], cost,
                           cost.new_tensor(1e6))

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid, img_shape):
        """The assignment and the focal / L1 / GIoU losses of every decoder
        layer (``.d{i}`` suffixes but for the last).  gt_bboxes (B, G, 4)
        xyxy in input-resolution pixels, gt_labels (B, G) int, gt_valid
        (B, G) bool, img_shape (B, 2) [h, w]."""
        cls, bbox = preds['cls_scores'], preds['bbox_preds']
        layers, b, q, _ = cls.shape
        g = gt_labels.shape[1]
        solver = dict(dict(self.train_cfg or {}).get('assigner', {})).get(
            'solver', 'auction')
        factor = _whwh(img_shape)
        gt_cxcywh = box_xyxy_to_cxcywh(gt_bboxes / factor[:, None])
        with torch.no_grad():
            cost = self.match_cost(cls, bbox, gt_cxcywh, gt_labels, gt_valid,
                                   factor)
            match = auction_match if solver == 'auction' else hungarian_match
            assigned = match(cost.reshape(layers * b, q, g)).reshape(
                layers, b, g)
            # gt onto queries; a padding gt goes to a spare column q
            idx = torch.where(gt_valid[None], assigned, q)
            labels = idx.new_full((layers, b, q + 1), self.num_classes)
            labels.scatter_(2, idx, gt_labels.long()[None].expand(
                layers, -1, -1))
            targets = bbox.new_zeros((layers, b, q + 1, 4))
            targets.scatter_(2, idx[..., None].expand(-1, -1, -1, 4),
                             gt_cxcywh[None].expand(layers, -1, -1, -1))
            weights = bbox.new_zeros((layers, b, q + 1))
            weights.scatter_(2, idx, 1.0)
            labels, targets, weights = (labels[:, :, :q], targets[:, :, :q],
                                        weights[:, :, :q])
        losses = {}
        for layer in range(layers):
            suffix = '' if layer == layers - 1 else f'.d{layer}'
            w = weights[layer]
            avg = w.sum().clamp_min(1.0)
            losses[f'loss_cls{suffix}'] = self.loss_cls(
                cls[layer].reshape(b * q, -1), labels[layer].reshape(-1),
                avg_factor=avg)
            losses[f'loss_bbox{suffix}'] = self.loss_bbox(
                bbox[layer], targets[layer], weight=w[..., None],
                avg_factor=avg)
            losses[f'loss_iou{suffix}'] = self.loss_iou(
                box_cxcywh_to_xyxy(bbox[layer]) * factor[:, None],
                box_cxcywh_to_xyxy(targets[layer]) * factor[:, None],
                weight=w, avg_factor=avg)
        return losses

    # -- inference -------------------------------------------------------
    def get_bboxes(self, preds, img_shape, scale_factor=None, rescale=False):
        """The ``max_per_img`` best (query, class) pairs of the last decoder
        layer: ``bboxes`` (B, K, 5) [xyxy, score] and ``labels`` (B, K)."""
        max_per_img = dict(self.test_cfg or {}).get('max_per_img', 100)
        cls, bbox = preds['cls_scores'][-1], preds['bbox_preds'][-1]
        b, q, c = cls.shape
        topv, topi = topk_stable(cls.sigmoid().reshape(b, q * c),
                                 max_per_img)
        query_idx = torch.div(topi, c, rounding_mode='floor')
        boxes = bbox.gather(1, query_idx[..., None].expand(-1, -1, 4))
        xyxy = box_cxcywh_to_xyxy(boxes) * _whwh(img_shape)[:, None]
        if rescale and scale_factor is not None:
            xyxy = xyxy / torch.cat([scale_factor, scale_factor], -1)[:, None]
        return dict(bboxes=torch.cat([xyxy, topv[..., None]], -1),
                    labels=topi % c)
