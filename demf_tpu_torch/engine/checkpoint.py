"""Checkpoints of the port (``demf_tpu/engine/checkpoint.py``'s surface on
``torch.save``): save with pruning and resume the model ``state_dict``
(mmdet3d names), the optimizer state, the epoch and the update count that
drives the LR schedule; a ``meta`` dict that makes a checkpoint
self-describing; the params-only warm start; and the DeMF stage-1 ->
stage-2 remap on torch keys.

The JAX package writes orbax checkpoints with a ``.meta.json`` beside
them; the two formats are not shared.  Weights cross between the packages
through ``engine/weights.py`` and ``demf_tpu.engine.torch_port``.  Files
load with ``weights_only=True``, so ``meta`` holds plain types only (str,
int, float, bool, None, and lists / dicts of them).
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r'epoch_(\d+)\.pth')


def _ckpt_dir(work_dir):
    return os.path.join(work_dir, 'checkpoints')


def _epochs(work_dir):
    """The ``epoch_<n>.pth`` files of ``work_dir``, oldest first."""
    path = _ckpt_dir(work_dir)
    if not os.path.isdir(path):
        return []
    found = [(int(m.group(1)), os.path.join(path, name))
             for name in os.listdir(path)
             for m in [_NAME.fullmatch(name)] if m]
    return [p for _, p in sorted(found)]


def _check_plain(value, where='meta'):
    """Raise unless ``value`` is made of the types a ``weights_only`` load
    takes back (a ``str`` subclass such as ``torch.__version__`` is not)."""
    if isinstance(value, dict):
        for k, v in value.items():
            _check_plain(k, where)
            _check_plain(v, f'{where}[{k!r}]')
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_plain(v, f'{where}[{i}]')
    elif value is not None and type(value) not in (str, int, float, bool):
        raise TypeError(f'{where} is a {type(value).__name__}: checkpoint '
                        f'meta holds plain types only')


def save_checkpoint(work_dir, model, optimizer, epoch, count=0, keep=-1,
                    meta=None):
    """Write ``work_dir/checkpoints/epoch_<epoch + 1>.pth``; returns it.

    ``count`` is the number of updates taken so far (the train step's
    ``count``: the LR schedule resumes from it).  ``meta`` is stored with
    ``epoch`` added.  With ``keep`` > 0 only the newest ``keep`` checkpoints
    of the directory stay (mmcv's ``max_keep_ckpts``).
    """
    path = os.path.join(_ckpt_dir(work_dir), f'epoch_{epoch + 1}.pth')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = dict(state_dict=model.state_dict(),
                   optimizer=optimizer.state_dict(), epoch=epoch,
                   count=int(count))
    if meta:
        _check_plain(meta)
        payload['meta'] = dict(meta, epoch=epoch)
    torch.save(payload, path)
    if keep and keep > 0:
        for old in _epochs(work_dir)[:-keep]:
            os.remove(old)
    return path


def load_checkpoint(path, model, optimizer=None, train_step=None):
    """Load a checkpoint into ``model`` (strict) and, when given, into
    ``optimizer`` and ``train_step`` (its update ``count``); returns the
    epoch it was written at."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt['state_dict'], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    if train_step is not None:
        if 'count' not in ckpt:
            raise KeyError(f'{path} holds no update count: the LR schedule '
                           f'cannot resume from it')
        train_step.count = ckpt['count']
    return ckpt['epoch']


def load_meta(path):
    """The ``meta`` dict a checkpoint was saved with (None if it has
    none): the eval entry point reads ``CLASSES`` from it."""
    return torch.load(path, map_location='cpu', weights_only=True).get('meta')


def latest_checkpoint(work_dir):
    """The checkpoint of the highest epoch under ``work_dir`` (or None)."""
    found = _epochs(work_dir)
    return found[-1] if found else None


def load_weights(path, model):
    """Warm start (a config's ``load_from``): the parameters and buffers of
    a checkpoint, or of a bare ``state_dict`` file, into ``model`` after
    ``remap_img_branch_keys``, not strict.  Returns (missing keys,
    unexpected keys)."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state = remap_img_branch_keys(ckpt.get('state_dict', ckpt))
    result = model.load_state_dict(state, strict=False)
    return list(result.missing_keys), list(result.unexpected_keys)


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
