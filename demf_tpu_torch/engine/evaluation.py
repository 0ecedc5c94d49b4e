"""Inference loops and the dataset evaluation loop (port of
``engine/trainer.py::make_eval_step`` and ``demf_tpu/engine/evaluation.py``).

``run_dataset_inference`` reads a dataset (``data.build_dataset``) scene by
scene, collates fixed-shape batches and returns per-scene detections for
``dataset.evaluate`` (the indoor mAP); ``run_batches_inference`` does the
same over batches that are already collated (dicts of numpy arrays:
``points``, ``img`` or ``img_features``, ``img_meta``), as
``data.loader.collate_fixed`` and the zoo's synthetic batches give them.
``make_eval_step(model, torch.bfloat16)`` runs the forward under the bf16
policy (``utils/precision.py``) and casts its results to float32 before
``get_bboxes``, so the NMS and the box count run in float32 as they do
without it; ``run_dataset_inference`` and the eval hook pass it on.
"""
from __future__ import annotations

from typing import Callable, Iterable, List

import numpy as np
import torch

from ..data.loader import collate_fixed
from ..utils.precision import (cast_batch, cast_floating, check_policy,
                               policy_call)


def batch_to_device(batch, device):
    """Nested dict / tuple of numpy arrays -> torch tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return tuple(batch_to_device(v, device) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch), device=device)


def make_eval_step(model, compute_dtype=None):
    """batch (tensors on the model's device) -> padded detections:
    boxes_3d (B, K, 7), scores_3d (B, K), labels_3d (B, K), valid (B, K)."""
    check_policy(model, compute_dtype)

    @torch.inference_mode()
    def eval_step(batch):
        results = cast_floating(policy_call(
            model, compute_dtype, cast_batch(batch, compute_dtype)),
            torch.float32)
        return model.get_bboxes(results, batch)

    return eval_step


def _scene_results(det, scenes):
    """Padded detections of a batch -> validity-filtered numpy results of
    its first ``scenes`` scenes."""
    det = {k: v.cpu().numpy() for k, v in det.items()}
    out = []
    for k in range(scenes):
        v = det['valid'][k]
        out.append(dict(boxes_3d=det['boxes_3d'][k][v],
                        scores_3d=det['scores_3d'][k][v],
                        labels_3d=det['labels_3d'][k][v]))
    return out


def run_batches_inference(model, batches: Iterable[dict]) -> List[dict]:
    """Run inference over collated numpy batches on the model's device and
    return per-scene numpy results, validity-filtered, in batch order."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model)
    results: List[dict] = []
    for batch in batches:
        det = eval_step(batch_to_device(batch, device))
        results.extend(_scene_results(det, det['valid'].shape[0]))
    return results


def run_dataset_inference(model, dataset, batch_size=16, max_gt=64,
                          progress_cb=None, compute_dtype=None) -> List[dict]:
    """Run inference over a whole dataset on the model's device (the
    caller puts the model in eval mode), returning per-scene numpy results,
    validity-filtered, in dataset order.  Every batch has ``batch_size``
    scenes: the last one is filled by repeating its last scene, and the
    fill is dropped."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model, compute_dtype)
    n = len(dataset)
    results: List[dict] = []
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        pad = batch_size - len(idx)
        samples = [dataset[i] for i in idx] + [dataset[idx[-1]]] * pad
        batch = collate_fixed(samples, max_gt=max_gt)
        results.extend(_scene_results(
            eval_step(batch_to_device(batch, device)), len(idx)))
        if progress_cb:
            progress_cb(len(results), n)
    return results


def make_dataset_eval_fn(dataset, batch_size, logger,
                         compute_dtype=None) -> Callable:
    """-> ``eval_fn(model, epoch)`` for the runner's eval hook: inference
    over ``dataset`` in eval mode, ``dataset.evaluate``, one log line; the
    model goes back to the mode it was in."""

    def eval_fn(model, epoch):
        was_training = model.training
        model.eval()
        try:
            results = run_dataset_inference(model, dataset, batch_size,
                                            compute_dtype=compute_dtype)
        finally:
            model.train(was_training)
        metrics = dataset.evaluate(results)
        logger(f'[eval @ epoch {epoch + 1}] ' + ' '.join(
            f'{k}: {v:.4f}' for k, v in metrics.items()))
        return metrics

    return eval_fn
