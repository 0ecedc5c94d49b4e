"""Checkpoints of the port: save and resume the model ``state_dict`` (mmdet3d
names), the optimizer state and the epoch with ``torch.save``; and the DeMF
stage-1 -> stage-2 warm-start remap on torch keys.

The JAX package writes orbax checkpoints (``demf_tpu/engine/checkpoint.py``);
the two formats are not shared.  Weights cross between the packages through
``engine/weights.py`` and ``demf_tpu.engine.torch_port``.
"""
from __future__ import annotations

import os
import re

import torch


def save_checkpoint(work_dir, model, optimizer, epoch):
    """Write ``work_dir/checkpoints/epoch_<epoch + 1>.pth``; returns it."""
    path = os.path.join(work_dir, 'checkpoints', f'epoch_{epoch + 1}.pth')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(dict(state_dict=model.state_dict(),
                    optimizer=optimizer.state_dict(), epoch=epoch), path)
    return path


def load_checkpoint(path, model, optimizer=None):
    """Load a checkpoint into ``model`` (strict) and, when given, into
    ``optimizer``; returns the epoch it was written at."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt['state_dict'], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    return ckpt['epoch']


def remap_img_branch_keys(state_dict):
    """DeMF warm start from a stage-1 image-branch checkpoint: the DETR
    encoder (``img_bbox_head.transformer.encoder.*`` and
    ``.level_embeds``) moves to ``img_encoder.*``; every other
    ``img_bbox_head`` key (decoder, classifier) is dropped."""
    out = {}
    for key, v in state_dict.items():
        if not re.search(r'(^|\.)img_bbox_head\.', key):
            out[key] = v
        elif 'encoder' in key or 'level_embeds' in key:
            out[re.sub(r'(^|\.)img_bbox_head\.transformer', r'\1img_encoder',
                       key)] = v
    return out
