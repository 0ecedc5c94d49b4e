"""Vote offset regression and the vote loss (port of
``demf_tpu/models/vote_module.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .pointnet2 import ConvModule


class VoteModule(nn.Module):
    """mmdet3d ``VoteModule``: ``vote_conv`` ConvModules + ``conv_out``;
    ``get_loss`` is the seed-weighted min-over-GT chamfer vote loss."""

    def __init__(self, in_channels=256, vote_per_seed=1, gt_per_seed=3,
                 conv_channels=(256, 256), norm_feats=True,
                 with_res_feat=True, vote_loss=None, conv_cfg=None,
                 norm_cfg=None):
        super().__init__()
        self.vote_per_seed = vote_per_seed
        self.gt_per_seed = gt_per_seed
        self.dst_weight = (vote_loss or {}).get('loss_dst_weight', 1.0)
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

    def get_loss(self, seed_points, vote_points, seed_indices,
                 vote_target_masks, vote_targets):
        """For each seed, the l1 distance from its vote to the nearest of
        its ``gt_per_seed`` GT votes, summed with weights normalized over
        the whole batch.

        seed_points (B, N, 3), vote_points (B, N*vps, 3), seed_indices
        (B, N) into the raw cloud, vote_target_masks (B, P), vote_targets
        (B, P, 3*gt_per_seed).
        """
        b, n = seed_points.shape[:2]
        gps = self.gt_per_seed
        idx = seed_indices.long()
        mask = torch.gather(vote_target_masks.float(), 1, idx)      # (B, N)
        gt_votes = torch.gather(vote_targets, 1,
                                idx[..., None].expand(-1, -1, 3 * gps))
        gt_votes = gt_votes + seed_points.repeat(1, 1, gps)
        weight = mask / (mask.sum() + 1e-6)
        votes = vote_points.reshape(b, n, self.vote_per_seed, 3)
        gts = gt_votes.reshape(b, n, gps, 3)
        d = (votes[:, :, :, None, :] - gts[:, :, None, :, :]).abs().sum(-1)
        dst = d.amin(2)                                          # (B, N, g)
        return (dst.amin(-1) * (self.dst_weight * weight)).sum()
