"""Inference loop (port of ``engine/trainer.py::make_eval_step`` and
``engine/evaluation.py::run_dataset_inference``).

Batches are collated dicts of numpy arrays (``points``, ``img`` or
``img_features``, ``img_meta``) as ``data.loader.collate_fixed`` and the
zoo's synthetic batches give them; reading the dataset is not ported yet.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


def batch_to_device(batch, device):
    """Nested dict / tuple of numpy arrays -> torch tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: batch_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return tuple(batch_to_device(v, device) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch), device=device)


def make_eval_step(model):
    """batch (tensors on the model's device) -> padded detections:
    boxes_3d (B, K, 7), scores_3d (B, K), labels_3d (B, K), valid (B, K)."""

    @torch.inference_mode()
    def eval_step(batch):
        results = model(batch)
        return model.get_bboxes(results, batch)

    return eval_step


def run_dataset_inference(model, batches: Iterable[dict]) -> List[dict]:
    """Run inference over collated numpy batches on the model's device and
    return per-scene numpy results, validity-filtered, in batch order."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model)
    results: List[dict] = []
    for batch in batches:
        det = eval_step(batch_to_device(batch, device))
        det = {k: v.cpu().numpy() for k, v in det.items()}
        for k in range(det['valid'].shape[0]):
            v = det['valid'][k]
            results.append(dict(boxes_3d=det['boxes_3d'][k][v],
                                scores_3d=det['scores_3d'][k][v],
                                labels_3d=det['labels_3d'][k][v]))
    return results
