"""Train step and epoch runner (port of ``demf_tpu/engine/trainer.py``).

One step: forward in train mode (BatchNorm batch statistics, dropout from
the caller's generator), the detector's loss, backward, the global-norm
clip with optax's rule, the scheduled learning rate, and AdamW.  The step
returns its metrics as device tensors and does no host sync, so steps queue
on the card back to back; the runner reads them only at its log interval.
The three phases are ``torch.profiler`` ranges (``PHASES``), which cost a
few microseconds when no profiler runs; ``train.py --profile`` reads them.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from .checkpoint import load_checkpoint, save_checkpoint
from .evaluation import batch_to_device
from .optim import clip_grad_global_norm, global_norm, set_lr

PHASES = ('train_step.forward', 'train_step.backward', 'train_step.optimizer')


def make_train_step(model, optimizer, scheduler=None, max_norm=None):
    """-> ``step(batch, generator) -> metrics``.

    ``batch`` holds tensors on the model's device (``points``,
    ``img_features`` or ``img``, ``img_meta``, ``gt_bboxes_3d``,
    ``gt_labels_3d``, ``gt_valid``); ``generator`` is a ``torch.Generator``
    on that device.  ``scheduler`` maps the update count to the base
    learning rate; ``max_norm`` turns the clip on.  Metrics: ``loss`` (the
    sum of the terms), each loss term, and ``grad_norm`` (before the
    clip), all 0-dim tensors.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    count = 0

    def step(batch, generator):
        nonlocal count
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with record_function(PHASES[0]):
            results = model(batch, generator=generator)
            losses = model.loss(results, batch)
            total = sum(losses.values())
        with record_function(PHASES[1]):
            total.backward()
        with record_function(PHASES[2]):
            if max_norm is not None:
                grad_norm = clip_grad_global_norm(params, max_norm)
            else:
                grad_norm = global_norm([p.grad for p in params
                                         if p.grad is not None])
            if scheduler is not None:
                set_lr(optimizer, scheduler(count))
            optimizer.step()
        count += 1
        metrics = dict(loss=total.detach())
        metrics.update({k: v.detach() for k, v in losses.items()})
        metrics['grad_norm'] = grad_norm.detach()
        return metrics

    return step


class Runner:
    """Epochs over an iterable of collated numpy batches: each batch goes
    to the device and through ``train_step``; every ``log_interval`` steps
    the metrics are read and logged; at the end of every
    ``checkpoint_interval`` epochs, with a ``work_dir``, a checkpoint is
    written (``engine/checkpoint.py``)."""

    def __init__(self, model, optimizer, train_step, batches, max_epochs=1,
                 log_interval=50, checkpoint_interval=1, work_dir=None,
                 seed=0, logger=print):
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.batches = batches
        self.max_epochs = max_epochs
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.work_dir = work_dir
        self.logger = logger
        self.start_epoch = 0
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def resume(self, path):
        self.start_epoch = load_checkpoint(path, self.model,
                                           self.optimizer) + 1

    def run(self):
        """Train to ``max_epochs``; returns the last metrics read."""
        last = {}
        for epoch in range(self.start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            for it, batch in enumerate(self.batches):
                metrics = self.train_step(batch_to_device(batch, self.device),
                                          self.generator)
                if (it + 1) % self.log_interval == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    seconds = (time.perf_counter() - t0) / (it + 1)
                    msg = ' '.join(f'{k}: {v:.4f}'
                                   for k, v in sorted(last.items()))
                    self.logger(f'Epoch [{epoch + 1}/{self.max_epochs}]'
                                f'[{it + 1}] {msg} ({seconds:.3f} s/step)')
            if self.work_dir and (epoch + 1) % self.checkpoint_interval == 0:
                save_checkpoint(self.work_dir, self.model, self.optimizer,
                                epoch)
        return last
