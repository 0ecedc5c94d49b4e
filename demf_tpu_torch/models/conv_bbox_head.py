"""Shared-trunk prediction head (port of
``demf_tpu/models/conv_bbox_head.py``, mmdet3d ``BaseConvBboxHead``)."""
from __future__ import annotations

from torch import nn

from ..utils.precision import dense
from .pointnet2 import SharedMLP


class BaseConvBboxHead(nn.Module):
    def __init__(self, in_channels=0, shared_conv_channels=(128, 128),
                 num_cls_out_channels=0, num_reg_out_channels=0, bias=True):
        super().__init__()
        self.shared_convs = SharedMLP(in_channels, shared_conv_channels,
                                      dims=1, bias=bias)
        c = shared_conv_channels[-1]
        self.conv_cls = nn.Conv1d(c, num_cls_out_channels, 1)
        self.conv_reg = nn.Conv1d(c, num_reg_out_channels, 1)

    def forward(self, features):
        """(B, N, C) -> (cls (B, N, C_cls), reg (B, N, C_reg))."""
        x = self.shared_convs(features)
        return dense(x, self.conv_cls), dense(x, self.conv_reg)
