"""Build the port's detector and its trainer from the shared ``configs/``,
and make synthetic batches (numpy) with the fields, shapes and meta of
``demf_tpu.zoo.synth_demf_batch``, value for value from the same seed."""
from __future__ import annotations

import os

import numpy as np
import torch

from .registry import DETECTORS, build_from_cfg
from .utils.config import Config

# the configs are data that both packages build from; they import nothing
CFG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                       'configs')

_DEPTH2CAM = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)


def load_model_cfg(rel_path):
    """The config at ``rel_path`` under the repository's ``configs/``."""
    return Config.fromfile(os.path.join(CFG_DIR, rel_path))


def _device(device):
    """``device`` as a ``torch.device``; raises when it names the card and
    there is none (nothing carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds its models on the GPU; pass "
            "device='cpu' for a small model on the CPU")
    return device


def build_detector(model_cfg, device='cuda', seed=0):
    """Detector from a model cfg dict (or a path under ``configs/``) with
    seeded random weights, in eval mode on ``device``: the card unless the
    caller passes ``'cpu'``; raises without a card."""
    from . import models
    device = _device(device)
    if isinstance(model_cfg, str):
        model_cfg = load_model_cfg(model_cfg).model
    model = build_from_cfg(model_cfg, DETECTORS)
    models.init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_trainer(cfg, device='cuda', seed=0, steps_per_epoch=1):
    """Detector (seeded random weights, train mode) plus its AdamW and train
    step, as the JAX package's ``train.py`` and ``bench.py`` set them up:
    the config's optimizer with the frozen image branch at lr_mult 0, its
    step LR schedule and its grad clip.

    ``cfg``: a path under ``configs/``, or a config / dict with ``model``,
    ``optimizer`` and optionally ``optimizer_config`` and ``lr_config``.
    ``device`` as in ``build_detector``.  Returns (model, optimizer,
    train_step).
    """
    from .engine.optim import build_optimizer, step_lr_schedule
    from .engine.trainer import make_train_step
    if isinstance(cfg, str):
        cfg = load_model_cfg(cfg)
    model = build_detector(cfg['model'], device, seed).train()
    optimizer = build_optimizer(model, cfg['optimizer'],
                                model.frozen_param_patterns())
    lr_cfg = cfg.get('lr_config') or {}
    scheduler = step_lr_schedule(
        cfg['optimizer']['lr'], steps_per_epoch, lr_cfg.get('step', []),
        warmup=lr_cfg.get('warmup'),
        warmup_iters=lr_cfg.get('warmup_iters', 500),
        warmup_ratio=lr_cfg.get('warmup_ratio', 1.0 / 3))
    clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    step = make_train_step(model, optimizer, scheduler,
                           clip['max_norm'] if clip else None)
    return model, optimizer, step


def synth_demf_batch(b, p=20000, g=32, hw=(800, 1344), seed=0,
                     valid_hw=None):
    """Synthetic DeMF batch: points + image + calibration / aug meta, as
    numpy arrays (``engine.evaluation.batch_to_device`` moves it)."""
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState(seed)     # the points draw their own stream
    points = prng.rand(b, p, 4).astype(np.float32) * 6 - 3
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :3] = prng.rand(b, g, 3) * 4 - 2
    boxes[..., 3:6] = prng.rand(b, g, 3) * 1.2 + 0.3
    boxes[..., 6] = prng.uniform(-np.pi, np.pi, (b, g))
    labels = prng.randint(0, 10, (b, g))
    gt_valid = prng.rand(b, g) < 0.5
    h, w = hw
    vh, vw = valid_hw or (h - 16, w - 32)
    k = np.array([[529.5, 0, vw / 2], [0, 529.5, vh / 2], [0, 0, 1]],
                 np.float32)
    d2i = np.eye(4, dtype=np.float32)
    d2i[:3, :3] = k @ _DEPTH2CAM
    meta = dict(
        img_shape=np.tile(np.array([[vh, vw]], np.int32), (b, 1)),
        scale_factor=np.ones((b, 2), np.float32),
        flip=np.zeros((b,), bool),
        depth2img=np.tile(d2i[None], (b, 1, 1)),
        pcd_rotation=np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
        pcd_scale_factor=np.ones((b,), np.float32),
        pcd_trans=np.zeros((b, 3), np.float32),
        pcd_horizontal_flip=np.zeros((b,), bool))
    return dict(points=points, gt_bboxes_3d=boxes, gt_labels_3d=labels,
                gt_valid=gt_valid,
                img=rng.rand(b, h, w, 3).astype(np.float32), img_meta=meta)
