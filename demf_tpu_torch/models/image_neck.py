"""Image necks (port of ``demf_tpu/models/image_neck.py``).

``ChannelMapper``: 1x1 convolutions with GroupNorm from each backbone
level to ``out_channels``, plus extra levels from the last input by 3x3
stride-2 convolutions.  GroupNorm runs in float32 and returns the dtype of
the convolution's input (``utils/precision.py``).  ``FPN`` (the ImVoteNet
baseline's): 1x1 laterals with bias, the top-down pathway (nearest x2
upsample, cropped to the finer level, added), 3x3 output convolutions, and
extra levels by a max-pool of window 1 and stride 2.  NHWC in and out.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..registry import NECKS
from ..utils.precision import conv, norm_as


class _ConvGN(nn.Module):
    """mmcv ConvModule with children ``conv`` and ``gn`` (no activation)."""

    def __init__(self, cin, cout, k, stride, num_groups):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.gn = nn.GroupNorm(num_groups, cout, eps=1e-5)

    def forward(self, x):
        gn = self.gn
        return norm_as(x.dtype, lambda y, w, b: F.group_norm(
            y, gn.num_groups, w, b, gn.eps), conv(self.conv, x), gn.weight,
            gn.bias)


@NECKS.register_module()
class ChannelMapper(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), out_channels=256,
                 kernel_size=1, num_outs=4, norm_cfg=None, act_cfg=None):
        super().__init__()
        if norm_cfg is None or act_cfg is not None:
            raise NotImplementedError('the port has the GN, no-activation '
                                      'ChannelMapper of the DeMF config')
        groups = norm_cfg.get('num_groups', 32)
        self.convs = nn.ModuleList(
            [_ConvGN(c, out_channels, kernel_size, 1, groups)
             for c in in_channels])
        extra, cin = [], in_channels[-1]
        for _ in range(num_outs - len(in_channels)):
            extra.append(_ConvGN(cin, out_channels, 3, 2, groups))
            cin = out_channels
        self.extra_convs = nn.ModuleList(extra)

    def forward(self, inputs):
        """inputs: tuple of (B, H, W, C_i) -> tuple of num_outs
        (B, h, w, out_channels) maps."""
        x = [f.permute(0, 3, 1, 2) for f in inputs]
        outs = [conv(f) for conv, f in zip(self.convs, x)]
        src = x[-1]
        for conv in self.extra_convs:
            src = conv(src)
            outs.append(src)
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


@NECKS.register_module()
class FPN(nn.Module):
    """mmdet ``FPN`` without extra convolutions, as the JAX package has it:
    ``lateral_convs.{i}.conv`` and ``fpn_convs.{i}.conv`` (mmcv's
    ConvModule names), no norm, no activation."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, start_level=0, add_extra_convs=False,
                 norm_cfg=None):
        super().__init__()
        if add_extra_convs or norm_cfg is not None:
            raise NotImplementedError('the port has the FPN of the ImVoteNet '
                                      'config: no extra convolutions, no norm')
        self.start_level = start_level
        self.num_outs = num_outs
        used = list(in_channels)[start_level:]
        self.lateral_convs = nn.ModuleList(
            [_Conv(c, out_channels, 1) for c in used])
        self.fpn_convs = nn.ModuleList(
            [_Conv(out_channels, out_channels, 3) for _ in used])

    def forward(self, inputs):
        """inputs: tuple of (B, H, W, C_i) -> tuple of num_outs
        (B, h, w, out_channels) maps."""
        used = [f.permute(0, 3, 1, 2) for f in inputs[self.start_level:]]
        laterals = [lat(x) for lat, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[-2:]
            up = laterals[i].repeat_interleave(2, -2).repeat_interleave(2, -1)
            laterals[i - 1] = laterals[i - 1] + up[..., :h, :w]
        outs = [fpn(x) for fpn, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, 2))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class _Conv(nn.Module):
    """mmcv ConvModule with a child ``conv`` only (bias, padding k // 2)."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x):
        return conv(self.conv, x)
