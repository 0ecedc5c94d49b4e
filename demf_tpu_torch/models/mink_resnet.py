"""Sparse-voxel ResNet backbone, MinkResNet 18 / 34 (port of
``demf_tpu/models/mink_resnet.py``).

mmdet3d's ``MinkResNet`` on the port's fixed-capacity voxel tables
(``ops/sparse.py``): a stem conv (k=3, s=2) + BN + ReLU and a 2x2x2 stride-2
max-pool, then 4 stages of BasicBlocks whose first block has stride 2, at
tensor strides 8 / 16 / 32 / 64.  A stage returns its 27-tap submanifold
table (with its row plan and its reverse for the backward), built once by
its first block and reused by the rest and by the FCAF3D head, and the
strided table into it.

Module and parameter names are mmdet3d's (``conv1.kernel``, ``norm1.bn``,
``layer{s}.{i}.conv1`` / ``norm1`` / ``conv2`` / ``norm2`` /
``downsample.0`` / ``downsample.1``), and a sparse kernel is (K^3, C_in,
C_out) in MinkowskiEngine's tap order (``ops/sparse.py``), so that a
released mmdet3d file loads as it is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse as S
from ..registry import BACKBONES


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (B, M, C) voxel features whose statistics count the
    valid rows only (``MinkowskiBatchNorm``: a BatchNorm1d under ``.bn``).
    Eval mode normalizes with the running statistics; train mode with the
    valid rows' mean and biased variance, moving the running ones as flax
    does (momentum 0.9).  Computes in float32 (float64 rows, a reference
    run's: in float64) and returns the input's dtype."""

    def __init__(self, channels, eps=1e-5, momentum=0.9):
        super().__init__()
        self.bn = nn.BatchNorm1d(channels, eps=eps)
        self.momentum = momentum

    def forward(self, x, valid):
        bn = self.bn
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        if self.training:
            w = valid[..., None].to(dtype)
            cnt = w.sum((0, 1)).clamp(min=1.0)
            mean = (xf * w).sum((0, 1)) / cnt
            var = ((xf - mean) ** 2 * w).sum((0, 1)) / cnt
            with torch.no_grad():
                m = self.momentum
                bn.running_mean.mul_(m).add_(mean, alpha=1 - m)
                bn.running_var.mul_(m).add_(var, alpha=1 - m)
        else:
            mean, var = bn.running_mean, bn.running_var
        y = (xf - mean) * torch.rsqrt(var + bn.eps) * bn.weight.to(dtype) + \
            bn.bias.to(dtype)
        return y.to(x.dtype)


class SparseConv(nn.Module):
    """A MinkowskiConvolution's parameters: ``kernel`` (K^3, C_in, C_out)
    in MinkowskiEngine's tap order, or (C_in, C_out) for a 1x1x1 kernel,
    and an optional ``bias`` (1, C_out).  The module holds the weights; the
    ops of ``ops/sparse.py`` apply them."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=False):
        super().__init__()
        shape = ((in_channels, out_channels) if kernel_size == 1 else
                 (kernel_size ** 3, in_channels, out_channels))
        self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(1, out_channels)) if bias \
            else None

    def init_weights(self, generator):
        """He normal over the fan-in (MinkowskiEngine's default)."""
        fan_in = self.kernel[..., 0].numel()
        with torch.no_grad():
            self.kernel.copy_(torch.randn(self.kernel.shape,
                                          generator=generator) *
                              (2.0 / fan_in) ** 0.5)

    @property
    def taps(self):
        """The kernel as (K^3, C_in, C_out)."""
        k = self.kernel
        return k[None] if k.dim() == 2 else k

    def dense(self, x):
        """A 1x1x1 conv as a matmul over the last axis, in the promoted
        dtype of ``x`` and the kernel."""
        w = self.kernel
        dtype = torch.promote_types(x.dtype, w.dtype)
        out = x.to(dtype) @ w.to(dtype)
        if self.bias is not None:
            out = out + self.bias.to(dtype)[0]
        return out


class SparseBasicBlock(nn.Module):
    """Two 3x3x3 convs + BNs with a residual; a stride-2 block's first conv
    is 2x2x2 and its shortcut a 1x1x1 stride-2 conv + BN (MinkResNet widens
    only in its stride-2 blocks)."""

    def __init__(self, in_channels, channels, stride=1, tensor_stride=1):
        super().__init__()
        self.stride = stride
        self.tensor_stride = tensor_stride
        self.conv1 = SparseConv(in_channels, channels, 2 if stride > 1 else 3)
        self.norm1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv(channels, channels, 3)
        self.norm2 = MaskedBatchNorm(channels)
        self.downsample = None
        if stride > 1:
            self.downsample = nn.Sequential(
                SparseConv(in_channels, channels, 1),
                MaskedBatchNorm(channels))
        elif in_channels != channels:
            raise ValueError('a stride-1 block keeps its width')

    def forward(self, st, table=None):
        """st (coords, valid, feats); ``table``: (nbr, plan, rev), the (B,
        M, 27) table of this block's output level, its ``conv_plan`` and its
        ``Reverse`` (stride-1 blocks; made here when not given).  A stride-2
        block makes its strided table and its output level's table in one
        K13 launch; the strided table's reverse (a parent table, one K13
        launch in the backward) is shared by the conv and the shortcut.
        Returns (st, table, down): ``down`` (stride-2 blocks, else None) the
        strided table with its plan as a ``Reverse``, the reverse of the
        transposed conv from this block's output level back to its input
        level."""
        coords, valid, x = st
        ts = self.tensor_stride
        down = None
        if self.stride > 1:
            coords_o, valid_o, y, nbr_s, nbr, plan_s, rev_s = \
                S.strided_conv_batched(
                    coords, valid, x, self.conv1.taps, stride=self.stride,
                    kernel_size=2, max_out=max(1, coords.shape[1] // 2),
                    tensor_stride=ts, sorted_input=True, level_kernel=3)
            table = (nbr, S.conv_plan(nbr), S.submanifold_reverse(nbr))
            down = S.Reverse.of(nbr_s, plan_s)
            out_ts = ts * self.stride
        else:
            coords_o, valid_o, out_ts = coords, valid, ts
            if table is None:
                nbr = S.submanifold_table(coords, valid, 3, ts)
                table = (nbr, S.conv_plan(nbr), S.submanifold_reverse(nbr))
            y = S.submanifold_conv_batched(coords, valid, x, self.conv1.taps,
                                           tensor_stride=ts, nbr=table[0],
                                           plan=table[1], rev=table[2])
        nbr, plan, rev = table
        y = F.relu(self.norm1(y, valid_o))
        y = S.submanifold_conv_batched(coords_o, valid_o, y, self.conv2.taps,
                                       tensor_stride=out_ts, nbr=nbr,
                                       plan=plan, rev=rev)
        y = self.norm2(y, valid_o)
        idn = x
        if self.downsample is not None:
            # each output voxel reads the input voxel at its coordinate:
            # tap 0, (0, 0, 0), of the strided table
            conv, norm = self.downsample
            idn = norm(S.sparse_conv_apply_batched(
                x, nbr_s[..., :1], conv.taps, rev=rev_s.taps(1)), valid_o)
        y = F.relu(y + idn)
        return ((coords_o, valid_o, torch.where(valid_o[..., None], y, 0)),
                table, down)


@BACKBONES.register_module()
class MinkResNet(nn.Module):
    """mmdet3d MinkResNet on the port's sparse ops.  Input (coords (B, M, 3)
    int32, valid (B, M), feats (B, M, C)), a key-sorted table; returns a
    list of the stages' (coords, valid, feats, nbr, plan, rev, down): each
    stage's 27-tap table, its K14 row plan and its ``Reverse``, which the
    head's convs at that level share, and the stage's strided table from
    the level before with its plan, as a ``Reverse`` (that of the head's
    transposed conv between the two levels)."""

    BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}

    def __init__(self, depth=34, in_channels=3, num_stages=4, pool=True,
                 norm='batch', stem_channels=64):
        super().__init__()
        if depth not in self.BLOCKS:
            raise NotImplementedError(f'MinkResNet depth {depth}: the port '
                                      f'has 18 and 34')
        if norm != 'batch':
            raise NotImplementedError(f'MinkResNet norm {norm!r}')
        self.pool = pool
        self.conv1 = SparseConv(in_channels, stem_channels, 3)
        self.norm1 = MaskedBatchNorm(stem_channels)
        ts = 4 if pool else 2
        cin = stem_channels
        for si, n_blocks in enumerate(self.BLOCKS[depth][:num_stages]):
            channels = stem_channels * 2 ** si
            blocks = []
            for bi in range(n_blocks):
                blocks.append(SparseBasicBlock(
                    cin, channels, stride=2 if bi == 0 else 1,
                    tensor_stride=ts))
                if bi == 0:
                    ts *= 2
                cin = channels
            self.add_module(f'layer{si + 1}', nn.ModuleList(blocks))
        self.num_stages = min(num_stages, 4)

    def forward(self, coords, valid, feats):
        c_s, v_s, x = S.strided_conv_batched(
            coords, valid, feats, self.conv1.taps, stride=2, kernel_size=3,
            max_out=max(1, coords.shape[1] // 2), tensor_stride=1,
            sorted_input=True)[:3]
        x = F.relu(self.norm1(x, v_s))
        st = (c_s, v_s, torch.where(v_s[..., None], x, 0))
        if self.pool:
            st = S.sparse_max_pool_batched(
                *st, max_out=max(1, c_s.shape[1] // 2), tensor_stride=2,
                sorted_input=True)
        outs = []
        for si in range(self.num_stages):
            first, *rest = getattr(self, f'layer{si + 1}')
            st, table, down = first(st)
            for block in rest:
                st, table, _ = block(st, table)
            outs.append((*st, *table, down))
        return outs
