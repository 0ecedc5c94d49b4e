"""Fold BatchNorm into the conv or linear before it, for inference (port of
``demf_tpu/engine/fuse_bn.py``; ``eval.py --fuse-conv-bn``).

The folded pairs are exactly the JAX package's, which matches flax names
(its ``_PAIR_RULES``); in the port's modules they are:

* a ``ConvModule``'s ``conv`` and ``bn`` (flax ``Dense_i`` / ``BatchNorm_i``:
  PointNet++'s SA / FP / vote-aggregation MLPs, the vote module's convs,
  the heads' shared convs, ImVoteNet's image-vote MLP);
* siblings ``conv<N>`` / ``bn<N>`` (the ResNet stem and bottlenecks);
* a bottleneck's ``downsample`` conv and BN;
* the learned position embedding's first conv and BN (flax ``fc1`` /
  ``bn``).

The sparse convolutions of MinkResNet and FCAF3D's head are bare kernels
in the JAX package, which no rule matches, so their ``MaskedBatchNorm``s
stay.  The transform is the JAX package's: the conv's weight and bias are
scaled by ``scale / sqrt(var + eps)`` on the output channel, and the BN is
kept as an identity scale plus the shift (``bias - mean * factor``, mean 0,
var ``1 - eps``), so the module graph is unchanged and bias-free convs stay
valid.
"""
from __future__ import annotations

import re

import torch
from torch import nn

_LINEAR = (nn.Conv1d, nn.Conv2d, nn.Linear)
_NORM = (nn.BatchNorm1d, nn.BatchNorm2d)


def conv_bn_pairs(model):
    """The (conv, bn) module pairs that ``fuse_conv_bn`` folds, in module
    order."""
    pairs = []
    for name, m in model.named_modules():
        kids = dict(m.named_children())
        for k, conv in kids.items():
            bn = None
            if k == 'conv':
                bn = kids.get('bn')
            elif re.fullmatch(r'conv\d+', k):
                bn = kids.get('bn' + k[4:])
            if isinstance(conv, _LINEAR) and isinstance(bn, _NORM):
                pairs.append((conv, bn))
        if (name.endswith('downsample') or
                name.endswith('position_embedding_head')) and \
                isinstance(m, nn.Sequential) and \
                isinstance(m[0], _LINEAR) and isinstance(m[1], _NORM):
            pairs.append((m[0], m[1]))
    return pairs


@torch.no_grad()
def fuse_conv_bn(model, eps=1e-5):
    """Fold every pair of ``conv_bn_pairs`` in place; returns their count."""
    pairs = conv_bn_pairs(model)
    for conv, bn in pairs:
        factor = bn.weight / torch.sqrt(bn.running_var + eps)
        conv.weight.mul_(factor.reshape((-1,) + (1,) * (conv.weight.dim() -
                                                        1)))
        if conv.bias is not None:
            conv.bias.mul_(factor)
        bn.bias.sub_(bn.running_mean * factor)
        bn.weight.copy_(torch.ones_like(bn.weight))
        bn.running_mean.zero_()
        bn.running_var.copy_(torch.ones_like(bn.running_var) - eps)
    return len(pairs)
