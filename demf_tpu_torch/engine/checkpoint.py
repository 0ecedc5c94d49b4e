"""Checkpoints of the port (``demf_tpu/engine/checkpoint.py``'s surface on
``torch.save``): save with pruning and resume the model ``state_dict``
(mmdet3d names), the optimizer state, the epoch and the update count that
drives the LR schedule; a ``meta`` dict that makes a checkpoint
self-describing; the params-only warm start; and the DeMF stage-1 ->
stage-2 remap on torch keys.

Three kinds of file load:
- the port's own (``save_checkpoint``), with ``epoch`` the index of the
  last epoch trained, the optimizer state and the update count;
- the JAX package's orbax checkpoints, once ``convert_jax_checkpoint.py``
  (at the repository's root: it imports both packages) has written them
  as the port's ``.pth`` with no optimizer state;
- released mmcv-format files as they are: the port's keys are mmdet3d's,
  and such a file keeps its epoch in ``meta['epoch']``, the count of
  epochs completed (the port's index is one less).  Its optimizer state is
  not the port's grouping, so it serves eval and ``load_from``, not a
  resume.
Files load with ``weights_only=True``, so ``meta`` holds plain types only
(str, int, float, bool, None, and lists / tuples / dicts of them); a file
that needs more is refused with the names of the globals it needs.
"""
from __future__ import annotations

import os
import pickle
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


def _read(path, device='cpu'):
    """``torch.load`` with ``weights_only=True``; a file that needs other
    globals raises with their names."""
    try:
        return torch.load(path, map_location=device, weights_only=True)
    except pickle.UnpicklingError as e:
        names = torch.serialization.get_unsafe_globals_in_checkpoint(path)
        raise ValueError(f'{path} needs globals that a weights_only load '
                         f'does not take: {names}') from e


def _is_mmcv(ckpt):
    """An mmcv-format file: its epoch only in ``meta``."""
    return 'epoch' not in ckpt and 'epoch' in (ckpt.get('meta') or {})


def check_plain(value, where='meta'):
    """Raise unless ``value`` is made of the types a ``weights_only`` load
    takes back (a ``str`` subclass such as ``torch.__version__`` is not)."""
    if isinstance(value, dict):
        for k, v in value.items():
            check_plain(k, where)
            check_plain(v, f'{where}[{k!r}]')
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            check_plain(v, f'{where}[{i}]')
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
        check_plain(meta)
        payload['meta'] = dict(meta, epoch=epoch)
    torch.save(payload, path)
    if keep and keep > 0:
        for old in _epochs(work_dir)[:-keep]:
            os.remove(old)
    return path


def _epoch(ckpt):
    """The port's epoch (the index of the last one trained) of a file."""
    if _is_mmcv(ckpt):
        return int(ckpt['meta']['epoch']) - 1
    return ckpt['epoch']


def load_checkpoint(path, model, optimizer=None, train_step=None):
    """Load a checkpoint into ``model`` (strict) and, when given, into
    ``optimizer`` and ``train_step`` (its update ``count``); returns the
    epoch it was written at (for an mmcv-format file ``meta['epoch'] -
    1``; its optimizer state is refused)."""
    device = next(model.parameters()).device
    ckpt = _read(path, device)
    if optimizer is not None and _is_mmcv(ckpt):
        raise ValueError(f'{path} is an mmcv-format checkpoint: its '
                         f'optimizer state is not the port\'s param groups, '
                         f'so it serves eval and load_from, not a resume')
    model.load_state_dict(ckpt['state_dict'], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    if train_step is not None:
        if 'count' not in ckpt:
            raise KeyError(f'{path} holds no update count: the LR schedule '
                           f'cannot resume from it')
        train_step.count = ckpt['count']
    return _epoch(ckpt)


def load_meta(path):
    """The ``meta`` dict a checkpoint was saved with (None if it has
    none), its ``epoch`` in the port's count: the eval entry point reads
    ``CLASSES`` from it."""
    ckpt = _read(path)
    meta = ckpt.get('meta')
    if meta is None:
        return None
    meta = dict(meta)
    if 'epoch' in meta or 'epoch' in ckpt:
        meta['epoch'] = _epoch(ckpt)
    return meta


def latest_checkpoint(work_dir):
    """The checkpoint of the highest epoch under ``work_dir`` (or None)."""
    found = _epochs(work_dir)
    return found[-1] if found else None


def load_weights(path, model):
    """Warm start (a config's ``load_from``): the parameters and buffers of
    a checkpoint, or of a bare ``state_dict`` file, into ``model`` after
    ``remap_img_branch_keys``, not strict.  Returns (missing keys,
    unexpected keys)."""
    ckpt = _read(path, next(model.parameters()).device)
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
