"""ResNet image backbone, depth 50 (port of ``demf_tpu/models/resnet.py``).

mmdet ``ResNet`` in the pytorch style (a stage's stride sits on its first
block's conv2) or the caffe style (on its conv1), as the JAX package puts
it (``style != 'pytorch'`` is caffe; the ImVoteNet baseline's Faster R-CNN
backbone is caffe).  NHWC in,
a tuple of NHWC stage outputs out; the convolutions run in NCHW inside.
``norm_eval`` pins BatchNorm to its running statistics whatever the mode
(every config sets it); without it a module in train mode normalizes with
the batch's statistics and updates the running ones by flax's rule.
``frozen_stages`` >= 0 freezes the stem and the stages up to it, as mmdet's
``_freeze_stages`` and the JAX package's ``stop_gradient`` do: their
parameters have ``requires_grad=False`` and the activation that leaves the
frozen part is detached, so no graph is kept below the first trained stage.
Under the bf16 policy the convolutions take their input's dtype and
BatchNorm runs in float32 and returns the block's input dtype, as in the
JAX package (``utils/precision.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import BACKBONES
from ..utils.precision import conv


def _bn(bn, x, dtype):
    """BatchNorm2d on NCHW: the running statistics in eval mode; in train
    mode the batch's (biased variance) with flax's update of the running
    ones, ``running = 0.9 * running + 0.1 * batch`` (biased variance too,
    where ``nn.BatchNorm2d`` would store the unbiased one).  It computes
    in float32 and returns ``dtype``."""
    x = x.float()
    weight, bias = bn.weight.float(), bn.bias.float()
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, weight,
                            bias, training=False, eps=bn.eps).to(dtype)
    mean = x.mean((0, 2, 3))
    var = (x * x).mean((0, 2, 3)) - mean * mean
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(0.1 * mean)
        bn.running_var.mul_(0.9).add_(0.1 * var)
    scale = weight * torch.rsqrt(var + bn.eps)
    return ((x - mean[:, None, None]) * scale[:, None, None] +
            bias[:, None, None]).to(dtype)


class Bottleneck(nn.Module):
    def __init__(self, in_channels, planes, stride=1, downsample=False,
                 style='pytorch'):
        super().__init__()
        out = planes * 4
        s1, s2 = (1, stride) if style == 'pytorch' else (stride, 1)
        self.conv1 = nn.Conv2d(in_channels, planes, 1, s1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, s2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride, bias=False),
                nn.BatchNorm2d(out))

    def forward(self, x):
        dt = x.dtype
        out = F.relu(_bn(self.bn1, conv(self.conv1, x), dt))
        out = F.relu(_bn(self.bn2, conv(self.conv2, out), dt))
        out = _bn(self.bn3, conv(self.conv3, out), dt)
        identity = x
        if hasattr(self, 'downsample'):
            identity = _bn(self.downsample[1], conv(self.downsample[0], x),
                           dt)
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNet(nn.Module):
    """``norm_cfg`` is accepted for config parity: the port has
    BatchNorm only."""

    def __init__(self, depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
                 frozen_stages=-1, norm_eval=True, style='pytorch',
                 norm_cfg=None, init_cfg=None):
        super().__init__()
        if depth != 50:
            raise NotImplementedError('the port has ResNet-50')
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for s, (n, planes) in enumerate(zip((3, 4, 6, 3)[:num_stages],
                                            (64, 128, 256, 512))):
            blocks = [Bottleneck(cin if i == 0 else planes * 4, planes,
                                 stride=(2 if s > 0 and i == 0 else 1),
                                 downsample=(i == 0), style=style)
                      for i in range(n)]
            self.add_module(f'layer{s + 1}', nn.Sequential(*blocks))
            cin = planes * 4
        self.num_stages = num_stages
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        for module in self._frozen_modules():
            module.requires_grad_(False)

    def _frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return [self.conv1, self.bn1] + [
            getattr(self, f'layer{s}')
            for s in range(1, self.frozen_stages + 1)]

    def frozen_param_patterns(self):
        """Name prefixes of the parameters that ``frozen_stages`` keeps
        still (they have ``requires_grad=False``, so no optimizer sees
        them): the JAX package's list in the port's spelling."""
        if self.frozen_stages < 0:
            return []
        return ['conv1', 'bn1'] + [
            f'layer{s}.' for s in range(1, self.frozen_stages + 1)]

    def train(self, mode=True):
        """Train mode reaches the BatchNorms only without ``norm_eval``."""
        super().train(mode and not self.norm_eval)
        return self

    def forward(self, img):
        """img (B, H, W, 3) -> tuple of (B, h, w, C) stage outputs."""
        x = img.permute(0, 3, 1, 2)
        x = F.relu(_bn(self.bn1, conv(self.conv1, x), x.dtype))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for s in range(self.num_stages):
            x = getattr(self, f'layer{s + 1}')(x)
            if s + 1 <= self.frozen_stages:
                x = x.detach()
            if s in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
