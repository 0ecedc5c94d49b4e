"""Seeded random weights for a freshly built model (no checkpoint)."""
from __future__ import annotations

import torch
from torch import nn

from .transformer import InProjAttention


@torch.no_grad()
def init_weights(model, generator):
    """Fill every parameter from ``generator``: convolutions and linears
    normal with std 1/sqrt(fan_in) and zero bias, norms at identity with
    unit running variance, level embeds standard normal; then each module
    with an ``init_weights(generator)`` of its own (the MSDA layers' DETR
    grid) runs it."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm,
                            nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, InProjAttention):
            normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
    for m in model.modules():
        if hasattr(m, 'level_embeds'):
            normal_(m.level_embeds, 1.0)
        if hasattr(m, 'init_weights'):     # module-specific init last
            m.init_weights(generator)
    return model
