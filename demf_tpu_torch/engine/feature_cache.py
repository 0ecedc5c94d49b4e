"""Frozen image-branch feature cache (port of
``demf_tpu/engine/feature_cache.py``).

DeMF freezes its image branch and its image pipeline is deterministic per
scene, so each scene's encoded feature levels are computed once and the
stage-2 step trains on them.  The on-disk format is the JAX package's: one
``<scene_id>.npz`` per scene holding float16 ``lvl0..lvl3`` NHWC arrays
without the batch axis, so a cache written by either package loads in the
other.  The cache is filled in float32 (the frozen branch's own precision,
as in the JAX package) and read back as float32; under the bf16 policy the
train step casts the features to bf16 (``img_features`` is one of
``utils/precision.py``'s cast keys), without it they stay float32.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def compute_image_features(model, batch):
    """The frozen image branch on a batch (tensors on the model's device)
    -> tuple of NHWC feature tensors."""
    with torch.inference_mode():
        return tuple(model.extract_img_feat(batch['img'],
                                            batch['img_meta']['img_shape']))


class FeatureCache:
    """Disk cache of per-scene feature levels with a bounded RAM layer."""

    def __init__(self, cache_dir, ram_budget_bytes=2 << 30):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._ram = {}
        self._ram_bytes = 0
        self._ram_budget = ram_budget_bytes

    def path(self, scene_id):
        return os.path.join(self.cache_dir, f'{scene_id}.npz')

    def has(self, scene_id):
        return scene_id in self._ram or os.path.exists(self.path(scene_id))

    def save(self, scene_id, feats: Sequence):
        """feats: one scene's levels, (H_l, W_l, C) arrays or tensors."""
        np.savez(self.path(scene_id), **{
            f'lvl{i}': np.asarray(torch.as_tensor(f).detach().cpu(),
                                  np.float16)
            for i, f in enumerate(feats)})

    def load(self, scene_id):
        """One scene's levels as float32 numpy arrays."""
        if scene_id in self._ram:
            return self._ram[scene_id]
        with np.load(self.path(scene_id)) as z:
            out = tuple(z[f'lvl{i}'].astype(np.float32)
                        for i in range(len(z.files)))
        size = sum(f.nbytes for f in out)
        if self._ram_bytes + size <= self._ram_budget:
            self._ram[scene_id] = out
            self._ram_bytes += size
        return out


def precompute_dataset_features(model, dataset, cache, batch_size=8,
                                max_gt=64, progress_cb=None):
    """Fill the cache for every scene of a dataset (one pass, batched; a
    batch whose scenes are all cached is skipped; the last batch is filled
    by repeating its last scene).  Under a process group each rank fills
    every ``world``-th batch from its rank on, and all wait for the others
    before they read the cache."""
    from ..data.loader import collate_fixed
    from ..parallel import rank_and_world
    from .evaluation import batch_to_device
    device = next(model.parameters()).device
    n = len(dataset)
    rank, world = rank_and_world()
    for start in range(rank * batch_size, n, world * batch_size):
        ids = list(range(start, min(start + batch_size, n)))
        if all(cache.has(i) for i in ids):
            continue
        pad = batch_size - len(ids)
        samples = [dataset[i] for i in ids] + [dataset[ids[-1]]] * pad
        batch = collate_fixed(samples, max_gt=max_gt)
        feats = compute_image_features(model, batch_to_device(
            dict(img=batch['img'], img_meta=batch['img_meta']), device))
        feats = [f.cpu() for f in feats]
        for k, sid in enumerate(ids):
            cache.save(sid, [f[k] for f in feats])
        if progress_cb:
            progress_cb(min(start + batch_size, n), n)
    if world > 1:
        dist.barrier()


class CachedFeatureLoader:
    """Wraps a DataLoader: swaps each batch's images for cached features."""

    def __init__(self, loader, cache):
        self.loader = loader
        self.cache = cache
        self.batch_size = loader.batch_size
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            yield attach_cached_features(batch, self.cache,
                                         batch['sample_idx'])


def attach_cached_features(batch, cache, scene_ids):
    """Collated numpy batch -> the same batch with 'img_features' (levels
    stacked over its scenes) in place of 'img'."""
    per_scene = [cache.load(int(s)) for s in scene_ids]
    out = dict(batch)
    out['img_features'] = tuple(np.stack([ps[lvl] for ps in per_scene])
                                for lvl in range(len(per_scene[0])))
    out.pop('img', None)
    return out
