"""Fixed-shape batching + background prefetch (the port's copy of
``demf_tpu/data/loader.py``, numpy only).

mmdet3d's ``build_dataloader`` (batch 16, 4 workers per GPU in
configs/_base_/datasets/sunrgbd-3d-10class.py): pipelines run on host
threads while the device trains on the previous batch; every batch is
padded to fixed shapes (``max_gt`` boxes + validity mask).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np

from ..parallel.dist import rank_and_world, rows_of_rank


def collate_fixed(samples, max_gt=64):
    """Stack per-sample dicts into fixed-shape numpy batches.

    GT boxes/labels are padded to ``max_gt`` with a ``gt_valid`` mask;
    numeric meta fields become batched arrays.
    """
    batch: Dict[str, Any] = {}
    b = len(samples)
    if 'points' in samples[0]:
        batch['points'] = np.stack([s['points'] for s in samples])

    if 'gt_bboxes' in samples[0]:  # 2D boxes (image-branch pretrain)
        boxes2d = np.zeros((b, max_gt, 4), np.float32)
        labels2d = np.zeros((b, max_gt), np.int32)
        valid2d = np.zeros((b, max_gt), bool)
        for i, s in enumerate(samples):
            g = min(len(s['gt_bboxes']), max_gt)
            boxes2d[i, :g] = s['gt_bboxes'][:g]
            labels2d[i, :g] = s['gt_labels'][:g]
            valid2d[i, :g] = True
        batch['gt_bboxes'] = boxes2d
        batch['gt_labels'] = labels2d
        batch['gt_bboxes_valid'] = valid2d

    if 'gt_bboxes_3d' in samples[0]:
        boxes = np.zeros((b, max_gt, 7), np.float32)
        labels = np.zeros((b, max_gt), np.int32)
        valid = np.zeros((b, max_gt), bool)
        for i, s in enumerate(samples):
            g = min(len(s['gt_bboxes_3d']), max_gt)
            boxes[i, :g] = s['gt_bboxes_3d'][:g]
            labels[i, :g] = s['gt_labels_3d'][:g]
            valid[i, :g] = True
        batch['gt_bboxes_3d'] = boxes
        batch['gt_labels_3d'] = labels
        batch['gt_valid'] = valid

    if 'img' in samples[0]:
        imgs = [s['img'] for s in samples]
        hw = [im.shape[:2] for im in imgs]
        ph, pw = max(h for h, _ in hw), max(w for _, w in hw)
        out = np.zeros((b, ph, pw, 3), np.float32)
        for i, im in enumerate(imgs):
            out[i, :im.shape[0], :im.shape[1]] = im
        batch['img'] = out

    metas = [s.get('img_meta', {}) for s in samples]
    meta_batch = {}
    for key, dim in (('depth2img', (4, 4)), ('pcd_rotation', (3, 3)),
                     ('pcd_trans', (3,))):
        if key in metas[0]:
            meta_batch[key] = np.stack(
                [np.asarray(m[key], np.float32) for m in metas])
    for key, default in (('pcd_scale_factor', 1.0),):
        if key in metas[0]:
            meta_batch[key] = np.asarray(
                [m.get(key, default) for m in metas], np.float32)
    for key in ('pcd_horizontal_flip', 'flip'):
        if key in metas[0]:
            meta_batch[key] = np.asarray(
                [bool(m.get(key, False)) for m in metas])
    if 'img_shape' in metas[0]:
        meta_batch['img_shape'] = np.asarray(
            [m['img_shape'][:2] for m in metas], np.int32)
    if 'scale_factor' in metas[0]:
        meta_batch['scale_factor'] = np.stack(
            [np.asarray(m['scale_factor'][:2], np.float32) for m in metas])
    batch['img_meta'] = meta_batch
    batch['sample_idx'] = np.asarray(
        [m.get('sample_idx', -1) for m in metas], np.int32)
    return batch


class DataLoader:
    """Epoch iterator: thread-pool sample processing + prefetch.

    The mmcv dataloader equivalent (workers_per_gpu -> num_threads): pipeline
    transforms are numpy and release the GIL for their hot parts, so a
    thread pool scales with the host's cores.

    ``batch_size`` is the global batch, as in the JAX package.  With
    ``world`` ranks every rank shuffles the same order and fetches and
    collates only its contiguous rows of each batch
    (``parallel.rows_of_rank``); the collate pads a rank's images to its own
    rows' largest, as each card of mmdet's distributed loader does.
    """

    def __init__(self, dataset, batch_size=16, shuffle=True, max_gt=64,
                 seed=0, drop_last=True, prefetch=2, num_threads=4,
                 collate_fn=None, rank=0, world=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_gt = max_gt
        # custom collate in place of collate_fixed
        self.collate_fn = collate_fn
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = max(1, num_threads)
        self._epoch = 0
        self._rows = rows_of_rank(batch_size, rank, world)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch):
        """The next iteration shuffles as epoch ``epoch`` of an unbroken
        run does (a resumed run calls this)."""
        self._epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _fetch(self, pool, sel):
        sel = sel[self._rows]
        if pool is None:
            samples = [self.dataset[i] for i in sel]
        else:
            samples = list(pool.map(self.dataset.__getitem__, sel))
        if self.collate_fn is not None:
            return self.collate_fn(samples)
        return collate_fixed(samples, self.max_gt)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        from concurrent.futures import ThreadPoolExecutor
        idx = self._indices()
        self._epoch += 1
        nb = len(self)
        pool = (ThreadPoolExecutor(self.num_threads)
                if self.num_threads > 1 else None)
        try:
            if self.prefetch <= 0:
                for bi in range(nb):
                    sel = idx[bi * self.batch_size:
                              (bi + 1) * self.batch_size]
                    yield self._fetch(pool, sel)
                return

            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            stop = object()
            err: list = []

            def worker():
                try:
                    for bi in range(nb):
                        sel = idx[bi * self.batch_size:
                                  (bi + 1) * self.batch_size]
                        q.put(self._fetch(pool, sel))
                except BaseException as e:   # surface in the consumer
                    err.append(e)
                finally:
                    q.put(stop)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    break
                yield item
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def build_dataloader(dataset, samples_per_gpu=16, workers_per_gpu=4,
                     shuffle=True, seed=0, max_gt=64, **kwargs):
    """A ``DataLoader`` of global batches of ``samples_per_gpu`` scenes;
    under a process group each rank's loader yields its rows of them."""
    rank, world = rank_and_world()
    return DataLoader(dataset, batch_size=samples_per_gpu, shuffle=shuffle,
                      seed=seed, max_gt=max_gt,
                      num_threads=max(1, workers_per_gpu),
                      collate_fn=kwargs.get('collate_fn'), rank=rank,
                      world=world)
