"""PointNet++ building blocks and the PointNet2SASSG backbone (port of
``demf_tpu/models/pointnet2.py``).

Features stay channel-last, (B, N, C); the 1x1 Conv+BN+ReLU stacks are
matmuls over the last axis that read the mmdet3d Conv1d / Conv2d weights.
BatchNorm follows flax (``bn_last``): batch statistics in train mode,
running statistics in eval mode.  Under the bf16 policy
(``utils/precision.py``) the grouped features go to the compute dtype after
the coordinate math, and every layer keeps its input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouping import (ball_query, gather_points_last,
                            group_points_last)
from ..ops.interpolate import three_nn_interpolate
from ..ops.sampling import furthest_point_sample
from ..parallel import global_moments
from ..registry import BACKBONES
from ..utils.precision import cast_compute, dense


def bn_last(bn, x):
    """BatchNorm over the last axis, as flax computes it:
    (x - mean) * (rsqrt(var + eps) * scale) + bias.

    Eval mode uses the running statistics.  Train mode uses the batch mean
    and the *biased* variance over every other axis (the sum over the
    count, then the squared deviations about it: ``parallel.global_moments``,
    whose sums run over every rank under a process group), and moves the
    running statistics as flax does with momentum 0.9:
    ``running = 0.9 * running + 0.1 * batch``, the biased variance included
    (``torch.nn.BatchNorm`` stores the unbiased one, so it is not used).

    As flax, it reduces and normalizes in float32 whatever the input's
    dtype (a bfloat16 sum would reduce in bfloat16), keeps the running
    statistics float32, and returns the input's dtype (a float64 input, a
    reference run's, stays float64).
    """
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    if bn.training:
        mean, var = global_moments(x, tuple(range(x.dim() - 1)))
        with torch.no_grad():
            bn.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            bn.running_var.mul_(0.9).add_(var, alpha=0.1)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(x.dtype)
    return ((x - mean) * mul + bn.bias.to(x.dtype)).to(dtype)


class ConvModule(nn.Module):
    """mmcv ConvModule (1x1 conv + BN + ReLU) applied over the last axis.

    ``dims`` picks the stored weight layout: 2 for the Conv2d of the SA / FP
    MLPs, 1 for the Conv1d of the vote module and the prediction heads.
    """

    def __init__(self, in_channels, out_channels, dims=2, bias=False):
        super().__init__()
        conv, bn = ((nn.Conv2d, nn.BatchNorm2d) if dims == 2 else
                    (nn.Conv1d, nn.BatchNorm1d))
        self.conv = conv(in_channels, out_channels, 1, bias=bias)
        self.bn = bn(out_channels)

    def forward(self, x):
        return F.relu(bn_last(self.bn, dense(x, self.conv)))


class SharedMLP(nn.Module):
    """ConvModules named ``layer0``, ``layer1``, ... (mmdet3d naming)."""

    def __init__(self, in_channels, channels, dims=2, bias=False):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f'layer{i}',
                            ConvModule(in_channels, c, dims, bias))
            in_channels = c

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class PointSAModule(nn.Module):
    """Single-scale set abstraction: FPS (or given indices / centers) ->
    exact ball query -> recenter (+ radius-normalize) -> shared MLP ->
    max-pool over the neighbours.

    ``mlp_channels[0]`` is the raw feature width; +3 is added for xyz.
    The ball query is always the exact nearest-K one, so
    ``ball_query_exact`` is accepted for config parity and not read.
    """

    def __init__(self, mlp_channels, num_point=None, radius=None,
                 num_sample=None, use_xyz=True, normalize_xyz=False,
                 pool_mod='max', ball_query_exact=True):
        super().__init__()
        if pool_mod not in ('max', 'avg'):
            raise ValueError(pool_mod)
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.pool_mod = pool_mod
        in_c = mlp_channels[0] + (3 if use_xyz or not mlp_channels[0] else 0)
        self.mlps = nn.ModuleList([SharedMLP(in_c, mlp_channels[1:])])

    def forward(self, points_xyz, features=None, indices=None,
                target_xyz=None):
        """points_xyz (B, N, 3), features (B, N, C) or None, optional
        indices (B, M) or target_xyz (B, M, 3) -> (new_xyz (B, M, 3),
        pooled (B, M, C_out), indices (B, M) or None)."""
        if indices is not None:
            new_xyz = gather_points_last(points_xyz, indices)
        elif target_xyz is not None:
            new_xyz = target_xyz
        else:
            indices = furthest_point_sample(points_xyz, self.num_point)
            new_xyz = gather_points_last(points_xyz, indices)
        idx = ball_query(self.radius, self.num_sample, points_xyz, new_xyz)
        grouped = group_points_last(points_xyz, idx) - new_xyz[:, :, None]
        if self.normalize_xyz:
            grouped = grouped / self.radius
        if features is not None:
            grouped_feats = group_points_last(features, idx)
            grouped = (torch.cat([grouped.to(grouped_feats.dtype),
                                  grouped_feats], -1)
                       if self.use_xyz else grouped_feats)
        # the coordinate math is done: the MLP runs in the policy's dtype
        out = self.mlps[0](cast_compute(grouped))
        pooled = out.amax(2) if self.pool_mod == 'max' else out.mean(2)
        return new_xyz, pooled, indices


class PointFPModule(nn.Module):
    """Feature propagation: 3-NN interpolation + skip concat + shared MLP."""

    def __init__(self, in_channels, mlp_channels):
        super().__init__()
        self.mlps = SharedMLP(in_channels, mlp_channels)

    def forward(self, target_xyz, source_xyz, target_feats, source_feats):
        new = three_nn_interpolate(target_xyz, source_xyz, source_feats)
        if target_feats is not None:
            new = torch.cat([new, target_feats], -1)
        return self.mlps(new)


@BACKBONES.register_module()
class PointNet2SASSG(nn.Module):
    """PointNet++ single-scale-grouping backbone (4 SA + 2 FP for DeMF).

    Returns the JAX package's dict contract: ``fp_xyz`` / ``fp_features`` /
    ``fp_indices`` and ``sa_xyz`` / ``sa_features`` / ``sa_indices`` lists.
    """

    def __init__(self, in_channels=4, num_points=(2048, 1024, 512, 256),
                 radius=(0.2, 0.4, 0.8, 1.2), num_samples=(64, 32, 16, 16),
                 sa_channels=((64, 64, 128), (128, 128, 256),
                              (128, 128, 256), (128, 128, 256)),
                 fp_channels=((256, 256), (256, 256)), norm_cfg=None,
                 sa_cfg=None):
        super().__init__()
        sa_cfg = dict(sa_cfg or {})
        sa_cfg.pop('type', None)
        self.in_channels = in_channels
        skip = [in_channels - 3]
        self.SA_modules = nn.ModuleList()
        for i, chans in enumerate(sa_channels):
            self.SA_modules.append(PointSAModule(
                [skip[-1]] + list(chans), num_point=num_points[i],
                radius=radius[i], num_sample=num_samples[i], **sa_cfg))
            skip.append(chans[-1])
        self.FP_modules = nn.ModuleList()
        source = skip.pop()
        for chans in fp_channels:
            self.FP_modules.append(
                PointFPModule(source + skip.pop(), list(chans)))
            source = chans[-1]

    def forward(self, points):
        """points: (B, N, in_channels) xyz + extra feature dims."""
        xyz = points[..., :3].contiguous()
        features = points[..., 3:] if self.in_channels > 3 else None
        b, n = points.shape[:2]
        sa_xyz, sa_features = [xyz], [features]
        sa_indices = [torch.arange(n, device=points.device).expand(b, n)]
        for sa in self.SA_modules:
            new_xyz, new_feats, idx = sa(sa_xyz[-1], sa_features[-1])
            sa_xyz.append(new_xyz)
            sa_features.append(new_feats)
            sa_indices.append(torch.gather(sa_indices[-1], 1, idx))
        fp_xyz, fp_features = [sa_xyz[-1]], [sa_features[-1]]
        fp_indices = [sa_indices[-1]]
        num_sa = len(self.SA_modules)
        for i, fp in enumerate(self.FP_modules):
            tgt = num_sa - i - 1
            fp_features.append(fp(sa_xyz[tgt], fp_xyz[-1], sa_features[tgt],
                                  fp_features[-1]))
            fp_xyz.append(sa_xyz[tgt])
            fp_indices.append(sa_indices[tgt])
        return dict(fp_xyz=fp_xyz, fp_features=fp_features,
                    fp_indices=fp_indices, sa_xyz=sa_xyz,
                    sa_features=sa_features, sa_indices=sa_indices)
