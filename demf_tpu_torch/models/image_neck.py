"""ChannelMapper image neck (port of ``demf_tpu/models/image_neck.py``).

1x1 convolutions with GroupNorm from each backbone level to
``out_channels``, plus extra levels from the last input by 3x3 stride-2
convolutions.  NHWC in and out.
"""
from __future__ import annotations

from torch import nn

from ..registry import NECKS


class _ConvGN(nn.Module):
    """mmcv ConvModule with children ``conv`` and ``gn`` (no activation)."""

    def __init__(self, cin, cout, k, stride, num_groups):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.gn = nn.GroupNorm(num_groups, cout, eps=1e-5)

    def forward(self, x):
        return self.gn(self.conv(x))


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
