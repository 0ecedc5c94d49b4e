"""Train step and epoch runner (port of ``demf_tpu/engine/trainer.py``).

One step: forward in train mode (BatchNorm batch statistics, dropout from
the caller's generator), the detector's loss, backward, the global-norm
clip with optax's rule, the scheduled learning rate, and AdamW.  The step
returns its metrics as device tensors and does no host sync, so steps queue
on the card back to back; the runner reads them only at its log interval.
The phases are ``torch.profiler`` ranges (``PHASES``), which cost a
few microseconds when no profiler runs; ``train.py --profile`` reads them.
Under a process group of several ranks (``parallel.dist``) each rank's loss
is its share of the global batch's, and a fourth phase sums the gradients
and the metrics over the ranks in one flat all-reduce before the clip, so
the clip, the schedule and the optimizer see the global batch's gradient on
every rank and the metrics are the global ones; only rank 0 writes logs,
TensorBoard scalars and checkpoints.
With ``compute_dtype=torch.bfloat16`` the step runs the JAX package's
mixed-precision policy (``utils/precision.py``): forward and backward on
bf16 copies of the float32 master weights, the batch's images / cached
features in bf16 and everything else float32, the results cast to float32
before the loss; the gradients, the clip, AdamW and the BatchNorm running
statistics stay float32, and nothing scales the loss.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from ..parallel import (is_distributed, rank_and_world, replicate,
                        sum_gradients)
from ..parallel.dist import rank_seed
from ..utils.precision import cast_batch, cast_floating, policy_call
from .checkpoint import load_checkpoint, save_checkpoint
from .evaluation import batch_to_device
from .optim import clip_grad_global_norm, global_norm, set_lr

PHASES = ('train_step.forward', 'train_step.backward',
          'train_step.all_reduce', 'train_step.optimizer')


class TrainStep:
    """``step(batch, generator) -> metrics``.

    ``batch`` holds tensors on the model's device (``points``,
    ``img_features`` or ``img``, ``img_meta``, ``gt_bboxes_3d``,
    ``gt_labels_3d``, ``gt_valid``); ``generator`` is a ``torch.Generator``
    on that device.  ``scheduler`` maps the update count to the base
    learning rate; ``max_norm`` turns the clip on.  Metrics: ``loss`` (the
    sum of the terms), each loss term, and ``grad_norm`` (before the
    clip), all 0-dim tensors.

    ``compute_dtype`` (None or ``torch.bfloat16``) selects the precision
    policy.  ``preprocess`` (``data.device_pipeline.make_device_preprocess``)
    turns a raw batch into the model's batch on the card first, without
    gradients and with the step's generator, as the JAX package's
    ``make_train_step(preprocess=)`` does inside its step; the loss reads
    the preprocessed batch.  ``count`` is the number of updates taken;
    ``lr`` the base rate of the last one.  A checkpoint saves the count and
    a resume restores it, so the schedule goes on where it stopped (in the
    JAX package the count lives in the optax state).
    """

    def __init__(self, model, optimizer, scheduler=None, max_norm=None,
                 compute_dtype=None, preprocess=None):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.max_norm = max_norm
        self.compute_dtype = compute_dtype
        self.preprocess = preprocess
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.count = 0
        self.lr = None

    def __call__(self, batch, generator):
        model = self.model
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with record_function(PHASES[0]):
            if self.preprocess is not None:
                with torch.no_grad():
                    batch = self.preprocess(batch, generator)
            dtype = self.compute_dtype
            # the float32 loss island (the reference's @force_fp32) under
            # the policy; without it the model's own dtype
            results = cast_floating(policy_call(
                model, dtype, cast_batch(batch, dtype), generator=generator),
                None if dtype is None else torch.float32)
            losses = model.loss(results, batch)
            total = sum(losses.values())
        with record_function(PHASES[1]):
            total.backward()
        metrics = dict(loss=total.detach())
        metrics.update({k: v.detach() for k, v in losses.items()})
        if is_distributed():
            with record_function(PHASES[2]):
                summed = sum_gradients(self.params, torch.stack(
                    list(metrics.values())))
                metrics = dict(zip(metrics, summed.unbind()))
        with record_function(PHASES[3]):
            if self.max_norm is not None:
                grad_norm = clip_grad_global_norm(self.params, self.max_norm)
            else:
                grad_norm = global_norm([p.grad for p in self.params
                                         if p.grad is not None])
            if self.scheduler is not None:
                self.lr = self.scheduler(self.count)
                set_lr(self.optimizer, self.lr)
            self.optimizer.step()
        self.count += 1
        metrics['grad_norm'] = grad_norm.detach()
        return metrics


def _tensorboard(work_dir):
    """A ``tensorboardX.SummaryWriter`` under ``work_dir/tf_logs`` when the
    package imports, else None (the original's own behaviour)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir=f'{work_dir}/tf_logs', flush_secs=30)


class Runner:
    """Epochs over an iterable of collated numpy batches (a
    ``data.DataLoader``, a ``CachedFeatureLoader`` or a list): each batch
    goes to the device and through ``train_step``; every ``log_interval``
    steps the metrics are read and logged (and written as TensorBoard
    scalars when ``tensorboardX`` imports); at the end of every
    ``checkpoint_interval`` epochs, with a ``work_dir``, a checkpoint is
    written with ``meta`` and the directory pruned to ``max_keep_ckpts``
    (``engine/checkpoint.py``); at the end of every ``eval_interval``
    epochs ``eval_fn(model, epoch)`` runs.

    ``loader_wait_s`` and ``epoch_s`` add up, over the epochs run, the host
    time spent waiting for the next batch and the whole epoch's (to the
    end of its last step on the device).

    Under a process group every rank runs the loop on its rows of each
    batch, with its generator seeded from (``seed``, rank); only rank 0
    logs, writes TensorBoard scalars and checkpoints, every rank reads a
    resume and calls ``eval_fn``; rank 0's weights are broadcast to the
    others when the runner is made.
    """

    def __init__(self, model, optimizer, train_step, batches, max_epochs=1,
                 log_interval=50, checkpoint_interval=1, work_dir=None,
                 seed=0, logger=print, eval_fn=None, eval_interval=0,
                 max_keep_ckpts=-1, meta=None):
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.batches = batches
        self.max_epochs = max_epochs
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.work_dir = work_dir
        self.logger = logger
        self.eval_fn = eval_fn
        self.eval_interval = eval_interval
        self.max_keep_ckpts = max_keep_ckpts
        self.meta = meta
        self.start_epoch = 0
        self.loader_wait_s = 0.0
        self.epoch_s = 0.0
        self.device = next(model.parameters()).device
        replicate(model)
        self.rank, world = rank_and_world()
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, self.rank, world))
        self._tb = (_tensorboard(work_dir) if work_dir and self.rank == 0
                    else None)

    def resume(self, path):
        """Model, optimizer, epoch and update count from a checkpoint; the
        loader goes on with the shuffle of the next epoch (``run`` sets
        it), not with epoch 0's."""
        self.start_epoch = load_checkpoint(path, self.model, self.optimizer,
                                           self.train_step) + 1

    def _log(self, epoch, it, metrics, seconds):
        last = {k: float(v) for k, v in metrics.items()}
        if self.rank:
            return last
        msg = ' '.join(f'{k}: {v:.4f}' for k, v in sorted(last.items()))
        self.logger(f'Epoch [{epoch + 1}/{self.max_epochs}][{it + 1}] {msg} '
                    f'({seconds:.3f} s/step)')
        if self._tb is not None:
            for k, v in last.items():
                self._tb.add_scalar(f'train/{k}', v, self.train_step.count)
        return last

    def run(self):
        """Train to ``max_epochs``; returns the last metrics read."""
        last = {}
        for epoch in range(self.start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            if hasattr(self.batches, 'set_epoch'):
                self.batches.set_epoch(epoch)
            batches = iter(self.batches)
            it = 0
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                self.loader_wait_s += time.perf_counter() - t_wait
                if batch is None:
                    break
                metrics = self.train_step(batch_to_device(batch, self.device),
                                          self.generator)
                if (it + 1) % self.log_interval == 0:
                    last = self._log(epoch, it, metrics,
                                     (time.perf_counter() - t0) / (it + 1))
                it += 1
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            self.epoch_s += time.perf_counter() - t0
            if self.work_dir and self.rank == 0 and \
                    (epoch + 1) % self.checkpoint_interval == 0:
                save_checkpoint(self.work_dir, self.model, self.optimizer,
                                epoch, count=self.train_step.count,
                                keep=self.max_keep_ckpts, meta=self.meta)
            if self.eval_fn and self.eval_interval and \
                    (epoch + 1) % self.eval_interval == 0:
                self.eval_fn(self.model, epoch)
        if self._tb is not None:
            self._tb.flush()
        return last
