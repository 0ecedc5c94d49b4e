"""Vote offset regression (port of ``demf_tpu/models/vote_module.py``,
forward only; the vote loss arrives with the training path)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .pointnet2 import ConvModule


class VoteModule(nn.Module):
    """mmdet3d ``VoteModule``: ``vote_conv`` ConvModules + ``conv_out``.
    ``gt_per_seed`` and ``vote_loss`` are training settings, accepted from
    the config and not read here."""

    def __init__(self, in_channels=256, vote_per_seed=1, gt_per_seed=3,
                 conv_channels=(256, 256), norm_feats=True,
                 with_res_feat=True, vote_loss=None, conv_cfg=None,
                 norm_cfg=None):
        super().__init__()
        self.vote_per_seed = vote_per_seed
        self.norm_feats = norm_feats
        self.with_res_feat = with_res_feat
        layers, c = [], in_channels
        for out_c in conv_channels:
            layers.append(ConvModule(c, out_c, dims=1))
            c = out_c
        self.vote_conv = nn.Sequential(*layers)
        out_dim = (3 + in_channels) if with_res_feat else 3
        self.conv_out = nn.Conv1d(c, out_dim * vote_per_seed, 1)

    def forward(self, seed_points, seed_feats):
        """seed_points (B, N, 3), seed_feats (B, N, C) -> vote_points
        (B, N*vps, 3), vote_feats (B, N*vps, C), vote_offset (B, N*vps, 3)."""
        b, n, c = seed_feats.shape
        vps = self.vote_per_seed
        x = self.vote_conv(seed_feats)
        out = F.linear(x, self.conv_out.weight.flatten(1), self.conv_out.bias)
        out = out.reshape(b, n, vps, -1)
        offset = out[..., 0:3]
        vote_points = (seed_points[:, :, None, :] + offset).reshape(
            b, n * vps, 3)
        if self.with_res_feat:
            vote_feats = (seed_feats[:, :, None, :] + out[..., 3:]).reshape(
                b, n * vps, c)
        else:
            vote_feats = seed_feats.repeat_interleave(vps, dim=1)
        if self.norm_feats:
            norm = vote_feats.norm(dim=-1, keepdim=True)
            vote_feats = vote_feats / norm.clamp_min(1e-12)
        return vote_points, vote_feats, offset.reshape(b, n * vps, 3)
