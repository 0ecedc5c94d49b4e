"""Transformer blocks: sine positional encoding, multi-scale deformable
attention, DETR encoder / decoder layers, the deformable image encoder and
the DeMF decoder layer (port of ``demf_tpu/models/transformer.py``).

Everything is batch-first (B, N, C) with static per-level spatial shapes.
Parameter names follow mmcv (``attentions`` / ``ffns`` / ``norms``).
LayerNorm epsilon is 1e-6, flax's default, as in the JAX package (mmcv
uses 1e-5).  Dropout sits where the JAX package puts it and, in train mode,
draws its masks from an explicit ``torch.Generator`` passed down from the
train step.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import multi_scale_deformable_attention
from ..registry import HEADS
from .pointnet2 import bn_last

LN_EPS = 1e-6


def dropout(x, p, training, generator):
    """Inverted dropout as flax's: keep with probability 1 - p, scaled by
    1 / (1 - p); identity in eval mode or at p == 0.  The mask comes from
    ``generator`` (a ``torch.Generator`` on x's device)."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in train mode needs a torch.Generator')
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class SinePositionalEncoding:
    """Stateless sine positional encoding (mmcv numerics)."""

    def __init__(self, num_feats=128, temperature=10000, normalize=False,
                 scale=2 * math.pi, offset=0., eps=1e-6):
        self.num_feats = num_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale
        self.offset = offset
        self.eps = eps

    def __call__(self, mask):
        """mask (B, H, W) bool, True = padding -> (B, H, W, 2*num_feats)."""
        not_mask = (~mask).float()
        y = not_mask.cumsum(1)
        x = not_mask.cumsum(2)
        if self.normalize:
            y = (y + self.offset) / (y[:, -1:, :] + self.eps) * self.scale
            x = (x + self.offset) / (x[:, :, -1:] + self.eps) * self.scale
        dim_t = torch.arange(self.num_feats, dtype=torch.float32,
                             device=mask.device)
        dim_t = self.temperature ** (2 * torch.div(
            dim_t, 2, rounding_mode='floor') / self.num_feats)
        px = x[..., None] / dim_t
        py = y[..., None] / dim_t
        px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                         -1).flatten(3)
        py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                         -1).flatten(3)
        return torch.cat([py, px], -1)


def msda_offset_bias_init(num_heads, num_levels, num_points):
    """DETR grid init of the sampling-offset bias (heads spread on a
    circle, point p at radius p + 1)."""
    thetas = np.arange(num_heads) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for p in range(num_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MultiScaleDeformableAttention(nn.Module):
    """mmcv MSDA layer (projections + residual), batch-first; the sampling
    core is kernels K3 / K4 (``ops/msda.py``).  ``dropout`` acts on the
    output projection, before the residual."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        n = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, n * 2)
        self.attention_weights = nn.Linear(embed_dims, n)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    @torch.no_grad()
    def init_weights(self, generator):
        """DETR init: zero offset weights with the grid bias, zero
        attention logits, random value / output projections."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            msda_offset_bias_init(self.num_heads, self.num_levels,
                                  self.num_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()
        for lin in (self.value_proj, self.output_proj):
            lin.weight.copy_(torch.randn(lin.weight.shape,
                                         generator=generator) *
                             lin.in_features ** -0.5)
            lin.bias.zero_()

    def forward(self, query, value, query_pos=None, key_padding_mask=None,
                reference_points=None, spatial_shapes=None, generator=None):
        """query (B, Nq, C), value (B, Nv, C), key_padding_mask (B, Nv) bool
        (True = padding), reference_points (B, Nq, L, 2) normalized,
        static spatial_shapes ((h, w), ...)."""
        h, l, p = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        b, nq, c = query.shape
        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        v = v.reshape(b, v.shape[1], h, c // h)
        offsets = self.sampling_offsets(query).reshape(b, nq, h, l, p, 2)
        attn = self.attention_weights(query).reshape(b, nq, h, l * p)
        attn = attn.softmax(-1).reshape(b, nq, h, l, p)
        normalizer = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                                  dtype=query.dtype, device=query.device)
        locs = reference_points[:, :, None, :, None, :] + \
            offsets / normalizer[None, None, None, :, None, :]
        out = multi_scale_deformable_attention(v, spatial_shapes, locs, attn)
        out = dropout(self.output_proj(out), self.dropout, self.training,
                      generator)
        return out + identity


class FFN(nn.Module):
    """mmcv FFN: ``layers.0.0`` Linear, ReLU, ``layers.1`` Linear,
    plus the residual; ``ffn_drop`` after the ReLU and after ``layers.1``."""

    def __init__(self, embed_dims=256, feedforward_channels=1024,
                 ffn_drop=0.0):
        super().__init__()
        self.ffn_drop = ffn_drop
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels),
                          nn.ReLU()),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x, generator=None):
        def drop(y):
            return dropout(y, self.ffn_drop, self.training, generator)

        y = drop(self.layers[0](x))
        return x + drop(self.layers[1](y))


class InProjAttention(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention``'s parameter
    names (``in_proj_weight`` = [Wq; Wk; Wv], ``out_proj``), batch-first;
    ``dropout`` acts on the attention probabilities, as flax's
    ``MultiHeadDotProductAttention`` does."""

    def __init__(self, embed_dims, num_heads, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, q, k, v, generator=None):
        b, nq, e = q.shape
        hd = e // self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, bias):
            return F.linear(x, w, bias).reshape(
                b, -1, self.num_heads, hd).transpose(1, 2)

        qh, kh, vh = heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv)
        logits = torch.matmul(qh / math.sqrt(hd), kh.transpose(-1, -2))
        probs = dropout(logits.softmax(-1), self.dropout, self.training,
                        generator)
        out = torch.matmul(probs, vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, e))


class MultiheadAttention(nn.Module):
    """mmcv MultiheadAttention: ``.attn`` plus query_pos / residual;
    ``dropout`` on the attention probabilities and on the output."""

    def __init__(self, embed_dims=256, num_heads=8, dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.attn = InProjAttention(embed_dims, num_heads, dropout)

    def forward(self, query, query_pos=None, generator=None):
        """Self-attention: keys take the same position as queries, values
        take none."""
        qk = query + query_pos if query_pos is not None else query
        out = self.attn(qk, qk, query, generator)
        return query + dropout(out, self.dropout, self.training, generator)


class DetrTransformerEncoderLayer(nn.Module):
    """self_attn (MSDA) -> LN -> FFN -> LN."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=1024, ffn_dropout=0.1,
                 attn_dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([MultiScaleDeformableAttention(
            embed_dims, num_heads, num_levels, num_points, attn_dropout)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       ffn_dropout)])
        self.norms = nn.ModuleList(
            [nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(2)])

    def forward(self, x, pos, key_padding_mask, reference_points,
                spatial_shapes, generator=None):
        x = self.attentions[0](x, x, query_pos=pos,
                               key_padding_mask=key_padding_mask,
                               reference_points=reference_points,
                               spatial_shapes=spatial_shapes,
                               generator=generator)
        x = self.norms[0](x)
        return self.norms[1](self.ffns[0](x, generator))


class DetrTransformerDecoderLayer(nn.Module):
    """self_attn (MHA) -> LN -> cross_attn (MSDA) -> LN -> FFN -> LN."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=1024, ffn_dropout=0.1,
                 self_attn_dropout=0.1, cross_attn_dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dims, num_heads, self_attn_dropout),
            MultiScaleDeformableAttention(embed_dims, num_heads, num_levels,
                                          num_points, cross_attn_dropout)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       ffn_dropout)])
        self.norms = nn.ModuleList(
            [nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3)])

    def forward(self, query, value, query_pos, key_padding_mask,
                reference_points, spatial_shapes, generator=None):
        q = self.norms[0](self.attentions[0](query, query_pos, generator))
        q = self.attentions[1](q, value, query_pos=query_pos,
                               key_padding_mask=key_padding_mask,
                               reference_points=reference_points,
                               spatial_shapes=spatial_shapes,
                               generator=generator)
        q = self.norms[1](q)
        return self.norms[2](self.ffns[0](q, generator))


def make_level_masks(img_shape, batch_hw, spatial_shapes):
    """Per-level padding masks (B, h, w) bool (True = padding): level pixel
    (i, j) is padding iff its nearest full-resolution pixel lies outside
    the image's valid (h, w)."""
    big_h, big_w = batch_hw
    masks = []
    for (h, w) in spatial_shapes:
        rows = torch.arange(h, device=img_shape.device) * big_h // h
        cols = torch.arange(w, device=img_shape.device) * big_w // w
        row_pad = rows[None, :] >= img_shape[:, :1]
        col_pad = cols[None, :] >= img_shape[:, 1:2]
        masks.append(row_pad[:, :, None] | col_pad[:, None, :])
    return masks


def get_valid_ratios(masks):
    """(B, L, 2) [w_ratio, h_ratio] of the valid area of each level."""
    ratios = []
    for m in masks:
        valid_h = (~m[:, :, 0]).sum(1).float() / m.shape[1]
        valid_w = (~m[:, 0, :]).sum(1).float() / m.shape[2]
        ratios.append(torch.stack([valid_w, valid_h], -1))
    return torch.stack(ratios, 1)


def encoder_reference_points(spatial_shapes, valid_ratios):
    """Pixel-center reference grid scaled by the valid ratios:
    (B, sum_HW, L, 2)."""
    b = valid_ratios.shape[0]
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32,
                          device=valid_ratios.device) + 0.5
        rx = torch.arange(w, dtype=torch.float32,
                          device=valid_ratios.device) + 0.5
        ry = ry[None, :] / (valid_ratios[:, lvl, 1:2] * h)
        rx = rx[None, :] / (valid_ratios[:, lvl, 0:1] * w)
        gx = rx[:, None, :].expand(b, h, w)
        gy = ry[:, :, None].expand(b, h, w)
        refs.append(torch.stack([gx, gy], -1).reshape(b, h * w, 2))
    refs = torch.cat(refs, 1)
    return refs[:, :, None, :] * valid_ratios[:, None, :, :]


class _Layers(nn.Module):
    """Holder that gives the encoder layers mmcv's ``encoder.layers`` path."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


@HEADS.register_module()
class DeformableDetrEncoder(nn.Module):
    """Deformable-DETR encoder used as the DeMF image encoder: padding
    masks + sine positions + learned level embeds, the levels flattened,
    N MSDA self-attention layers, un-flattened again.  NHWC in and out."""

    def __init__(self, encoder=None, positional_encoding=None,
                 num_feature_levels=4, embed_dims=256, init_cfg=None):
        super().__init__()
        enc_cfg = dict(encoder or {})
        tl = dict(enc_cfg.get('transformerlayers', {}))
        attn_cfg = dict(tl.get('attn_cfgs', {}))
        pe_cfg = dict(positional_encoding or {})
        pe_cfg.pop('type', None)
        self.pos_enc = SinePositionalEncoding(**pe_cfg)
        self.encoder = _Layers([DetrTransformerEncoderLayer(
            embed_dims, attn_cfg.get('num_heads', 8), num_feature_levels,
            attn_cfg.get('num_points', 4),
            tl.get('feedforward_channels', 1024), tl.get('ffn_dropout', 0.1),
            attn_cfg.get('dropout', 0.1))
            for _ in range(enc_cfg.get('num_layers', 6))])
        self.level_embeds = nn.Parameter(
            torch.zeros(num_feature_levels, embed_dims))

    def forward(self, mlvl_feats, img_shape, generator=None):
        """mlvl_feats: tuple of (B, H_l, W_l, C) maps; img_shape (B, 2)
        valid [h, w] at input resolution (level 0 has stride 8)."""
        spatial_shapes = tuple((f.shape[1], f.shape[2]) for f in mlvl_feats)
        batch_hw = (mlvl_feats[0].shape[1] * 8, mlvl_feats[0].shape[2] * 8)
        masks = make_level_masks(img_shape, batch_hw, spatial_shapes)
        valid_ratios = get_valid_ratios(masks)
        feats, poss, flat_masks = [], [], []
        for lvl, (feat, mask) in enumerate(zip(mlvl_feats, masks)):
            b, h, w, c = feat.shape
            pos = self.pos_enc(mask) + self.level_embeds[lvl]
            feats.append(feat.reshape(b, h * w, c))
            poss.append(pos.reshape(b, h * w, c))
            flat_masks.append(mask.reshape(b, h * w))
        x = torch.cat(feats, 1)
        pos = torch.cat(poss, 1)
        key_padding_mask = torch.cat(flat_masks, 1)
        reference_points = encoder_reference_points(spatial_shapes,
                                                    valid_ratios)
        for layer in self.encoder.layers:
            x = layer(x, pos, key_padding_mask, reference_points,
                      spatial_shapes, generator)
        outs, start = [], 0
        for (h, w) in spatial_shapes:
            outs.append(x[:, start:start + h * w].reshape(
                x.shape[0], h, w, x.shape[-1]))
            start += h * w
        return tuple(outs)


class PositionEmbeddingLearned(nn.Module):
    """Learned query position: Conv1d(6->C) + BN + ReLU + Conv1d over
    (center, size), as ``position_embedding_head`` indices 0, 1, 3."""

    def __init__(self, input_channel=6, num_pos_feats=256):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            nn.Conv1d(input_channel, num_pos_feats, 1),
            nn.BatchNorm1d(num_pos_feats), nn.ReLU(),
            nn.Conv1d(num_pos_feats, num_pos_feats, 1))

    def forward(self, xyz):
        """(B, N, input_channel) -> (B, N, num_pos_feats)."""
        fc1, bn, _, fc2 = self.position_embedding_head
        x = F.linear(xyz, fc1.weight.flatten(1), fc1.bias)
        x = F.relu(bn_last(bn, x))
        return F.linear(x, fc2.weight.flatten(1), fc2.bias)


class DeMFTransformerDecoderLayer(nn.Module):
    """DETR decoder layer with learned (center, size) query positions."""

    def __init__(self, transformerlayers=None, posembed=None, num_layers=1):
        super().__init__()
        tl = dict(transformerlayers or {})
        attn_cfgs = tl.get('attn_cfgs', [{}, {}])
        self_cfg, cross = dict(attn_cfgs[0]), dict(attn_cfgs[1])
        pe = dict(posembed or {})
        self.posembed = PositionEmbeddingLearned(
            pe.get('input_channel', 6), pe.get('num_pos_feats', 256))
        self.layer = DetrTransformerDecoderLayer(
            cross.get('embed_dims', 256), cross.get('num_heads', 8),
            cross.get('num_levels', 4), cross.get('num_points', 4),
            tl.get('feedforward_channels', 1024), tl.get('ffn_dropout', 0.1),
            self_cfg.get('dropout', 0.1), cross.get('dropout', 0.1))

    def forward(self, query, value, query_pos_input, key_padding_mask,
                reference_points, spatial_shapes, valid_ratios,
                generator=None):
        """query (B, Nq, C), value (B, Nv, C), query_pos_input (B, Nq, 6),
        reference_points (B, Nq, 2) normalized, valid_ratios (B, L, 2)."""
        ref = reference_points[:, :, None, :] * valid_ratios[:, None]
        query_pos = self.posembed(query_pos_input)
        return self.layer(query, value, query_pos, key_padding_mask, ref,
                          spatial_shapes, generator)
