"""ResNet image backbone, depth 50, inference (port of
``demf_tpu/models/resnet.py``).

mmdet ``ResNet`` in the pytorch style (the stride sits on conv2) with
eval-mode BatchNorm.  NHWC in, a tuple of NHWC stage outputs out; the
convolutions run in NCHW inside.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..registry import BACKBONES


def _bn(bn, x):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


class Bottleneck(nn.Module):
    def __init__(self, in_channels, planes, stride=1, downsample=False):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride, bias=False),
                nn.BatchNorm2d(out))

    def forward(self, x):
        out = F.relu(_bn(self.bn1, self.conv1(x)))
        out = F.relu(_bn(self.bn2, self.conv2(out)))
        out = _bn(self.bn3, self.conv3(out))
        identity = x
        if hasattr(self, 'downsample'):
            identity = _bn(self.downsample[1], self.downsample[0](x))
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNet(nn.Module):
    """``frozen_stages``, ``norm_eval``, ``norm_cfg`` and ``style`` are
    accepted for config parity: inference uses the running statistics and
    the pytorch style only."""

    def __init__(self, depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
                 frozen_stages=-1, norm_eval=True, style='pytorch',
                 norm_cfg=None, init_cfg=None):
        super().__init__()
        if depth != 50 or style != 'pytorch':
            raise NotImplementedError('the port has ResNet-50, pytorch style')
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for s, (n, planes) in enumerate(zip((3, 4, 6, 3)[:num_stages],
                                            (64, 128, 256, 512))):
            blocks = [Bottleneck(cin if i == 0 else planes * 4, planes,
                                 stride=(2 if s > 0 and i == 0 else 1),
                                 downsample=(i == 0)) for i in range(n)]
            self.add_module(f'layer{s + 1}', nn.Sequential(*blocks))
            cin = planes * 4
        self.num_stages = num_stages

    def forward(self, img):
        """img (B, H, W, 3) -> tuple of (B, h, w, C) stage outputs."""
        x = img.permute(0, 3, 1, 2)
        x = F.relu(_bn(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s in range(self.num_stages):
            x = getattr(self, f'layer{s + 1}')(x)
            if s in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
