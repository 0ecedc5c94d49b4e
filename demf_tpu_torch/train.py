"""Train a detector with the port (the repository's ``train.py`` on
PyTorch + CUDA).

    python -m demf_tpu_torch.train <config> [--work-dir DIR]
        [--resume-from CKPT] [--no-validate] [--cfg-options k=v ...]

reads the config's dataset through its pipeline (``data.build_dataset``,
``build_dataloader``), builds the detector (seeded random weights, or the
config's ``load_from`` warm start), its AdamW, its step LR schedule from
the loader's length and its train step (``zoo.build_trainer``), fills the
frozen image-feature cache when the config sets ``cached_img_features``,
and trains ``runner.max_epochs`` epochs through ``engine.Runner``: a log
file and a dump of the config in the work dir, checkpoints with meta
pruned to ``checkpoint_config.max_keep_ckpts``, the mAP on ``data.val``
every ``evaluation.interval`` epochs.  A config's ``bf16 = True`` or
``fp16 = dict(...)`` (``--cfg-options bf16=True``) trains and evaluates
under the bf16 policy (``utils/precision.py``), in both modes.

    python -m demf_tpu_torch.train configs/demf/demf_votenet.py \\
        --synthetic --steps 3 [--profile]

takes ``--steps`` steps on one synthetic batch (``zoo.synth_batch_for``
the model: scenes for DeMF and ImVoteNet, points for VoteNet, images with
2D boxes for the stage-1 pretrain of
``configs/deformdetr/imvotenet_deform.py``; DeMF's frozen image branch's
features are cached once, ImVoteNet's 2D branch runs in every step)
instead of reading a dataset;
``--profile`` then traces one more step with ``torch.profiler`` and prints
its kernels by device time, the device's busy share and the step's phases.

Both run on the GPU by default and stop when there is none; ``--device
cpu`` takes the plain versions of the kernels (for small sizes only).

With a launcher both modes train data-parallel, one process a card:

    torchrun --nproc_per_node 8 -m demf_tpu_torch.train <config> \
        --launcher pytorch
    srun -N 2 --ntasks-per-node 8 --gpus-per-task 1 \
        python -m demf_tpu_torch.train <config> --launcher slurm

``samples_per_gpu`` (``--batch`` in synthetic mode) stays the global batch,
split over the ranks; the BatchNorm statistics, the loss normalizers and the
gradient are the global batch's (``parallel.dist``), so the ranks train
what one process trains on the whole batch.  Only rank 0 writes the work
dir's log, config dump and checkpoints.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import __version__, zoo
from .data import build_dataloader, build_dataset
from .engine import (CachedFeatureLoader, FeatureCache, Runner,
                     batch_to_device, compute_image_features, load_weights,
                     make_dataset_eval_fn, precompute_dataset_features)
from .engine.cli import parse_args, set_deterministic, setup_device
from .engine.trainer import PHASES
from .parallel import rank_and_world, shard_batch
from .utils.config import Config
from .utils.precision import resolve_compute_dtype


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize()


def profile_step(step, batch, generator, device, rows=20):
    """Time one step on the host clock, then trace one more with
    ``torch.profiler`` and print the device kernels by self time, their
    sum (the device's busy time) and its share of the untraced step, and
    the step's phases (``engine.trainer.PHASES``): each one's host time and
    the device time of the kernels launched inside it, by any thread (the
    backward runs on autograd's device thread while the caller waits)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    t0 = time.perf_counter()
    step(batch, generator)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        step(batch, generator)
        _sync(device)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.key not in PHASES),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f'profiled step: untraced step {wall_ms:.3f} ms (host clock), '
          f'device kernels {busy_ms:.3f} ms in {len(kernels)} kinds, '
          f'busy share {busy_ms / wall_ms:.1%}')
    # a device event belongs to the phase whose host range holds the CUDA
    # runtime call with its correlation id; the port's kernels launch
    # through ctypes outside any aten op, which the op links miss
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name in PHASES and e.device_type == DeviceType.CPU}
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith('cu')}
    phase_us = dict.fromkeys(ranges, 0.0)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in PHASES:
            continue
        for name, r in ranges.items():
            if r.start <= calls.get(e.id, -1.0) < r.end:
                phase_us[name] += e.time_range.elapsed_us()
    print('phases: ' + ', '.join(
        f'{name.split(".")[-1]} {r.elapsed_us() / 1e3:.3f} ms host, '
        f'{phase_us[name] / 1e3:.3f} ms device'
        for name, r in ranges.items()) +
        f'; device outside them {busy_ms - sum(phase_us.values()) / 1e3:.3f}'
        ' ms')
    for e in kernels[:rows]:
        print(f'  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  '
              f'{e.key[:100]}')
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=rows, max_name_column_width=60))


def train_synthetic(cfg, args, device):
    """``--steps`` steps on one synthetic batch, each logged; the schedule
    counts ``--steps`` as the epoch's length.  Under a process group the
    batch is the global one and each rank steps on its rows."""
    rank = rank_and_world()[0]
    model, optimizer, step = zoo.build_trainer(
        cfg, device, args.seed, steps_per_epoch=max(args.steps, 1))
    batch = batch_to_device(shard_batch(zoo.synth_batch_for(
        model, args.batch, p=args.points, g=args.gt, hw=args.hw,
        seed=args.seed)), device)
    if getattr(model, 'caches_img_features', False) and \
            model.freeze_img_branch:
        # else the image branch trains every step, runs inside the step
        # (ImVoteNet's 2D detector), or there is none
        t0 = time.perf_counter()
        batch['img_features'] = compute_image_features(model, batch)
        n = len(batch.pop('img'))
        _sync(device)
        if rank == 0:
            print(f'image features of {n} scenes cached in '
                  f'{time.perf_counter() - t0:.3f} s')
    runner = Runner(model, optimizer, step, [batch] * args.steps,
                    log_interval=1, work_dir=args.work_dir, seed=args.seed)
    runner.run()
    if args.profile and rank == 0:
        profile_step(step, batch, runner.generator, device)
    elif args.profile:
        # the other ranks take the same two steps, for the collectives
        step(batch, runner.generator)
        step(batch, runner.generator)


def train_dataset(cfg, args, device):
    """The config's dataset, schedule, checkpoints and eval hook; only rank
    0 writes the config dump and the log (the others log nothing)."""
    if args.work_dir:
        cfg.work_dir = args.work_dir
    elif not cfg.get('work_dir'):
        cfg.work_dir = os.path.join(
            'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(cfg.work_dir, exist_ok=True)
    if rank_and_world()[0]:
        _train_dataset(cfg, args, device, lambda msg: None)
        return
    cfg.dump(os.path.join(cfg.work_dir, os.path.basename(args.config)))
    log_file = os.path.join(cfg.work_dir,
                            time.strftime('%Y%m%d_%H%M%S') + '.log')
    with open(log_file, 'a') as log_fh:

        def logger(msg):
            line = f'{time.strftime("%Y-%m-%d %H:%M:%S")} - {msg}'
            print(line)
            log_fh.write(line + '\n')
            log_fh.flush()

        _train_dataset(cfg, args, device, logger)


def _train_dataset(cfg, args, device, logger):
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    rank, world = rank_and_world()
    logger(f'device: {name}' + (f', rank {rank} of {world}' if world > 1
                                else ''))
    logger(f'config: {args.config}')
    if resolve_compute_dtype(cfg) is not None:
        logger('compute dtype: bfloat16 (fp32 master weights)')
    if args.autoscale_lr:
        # one card a rank: the cards of all ranks
        cfg.optimizer['lr'] = cfg.optimizer['lr'] * world / 8.0
        logger(f'autoscaled lr to {cfg.optimizer["lr"]}')
    np.random.seed(args.seed)

    batch_size = cfg.data['samples_per_gpu']
    max_gt = cfg.get('max_gt', 64)
    dataset = build_dataset(cfg.data['train'])
    loader = build_dataloader(
        dataset, samples_per_gpu=batch_size,
        workers_per_gpu=cfg.data.get('workers_per_gpu', 4), shuffle=True,
        seed=args.seed, max_gt=max_gt)

    model, optimizer, step = zoo.build_trainer(
        cfg, device, args.seed, steps_per_epoch=max(len(loader), 1))
    n_params = sum(p.numel() for p in model.parameters())
    logger(f'model params: {n_params / 1e6:.2f}M')
    if cfg.get('load_from'):
        missing, unexpected = load_weights(cfg.load_from, model)
        logger(f'warm-started from {cfg.load_from} ({len(missing)} keys '
               f'missing, {len(unexpected)} unexpected)')
    frozen = model.frozen_param_patterns()
    if frozen:
        logger(f'frozen param patterns: {frozen}')

    if cfg.get('cached_img_features'):
        # frozen image branch + deterministic image pipeline => encode each
        # scene once and train the fusion stage from the cache
        cache = FeatureCache(os.path.join(cfg.work_dir, 'img_feat_cache'))
        logger('filling frozen image-feature cache ...')
        t0 = time.perf_counter()
        precompute_dataset_features(
            model, getattr(dataset, 'dataset', dataset), cache,
            batch_size=batch_size, max_gt=max_gt,
            progress_cb=lambda d, n: logger(f'  cache {d}/{n}'))
        loader = CachedFeatureLoader(loader, cache)
        logger(f'image-feature cache active '
               f'({time.perf_counter() - t0:.3f} s)')

    evaluation = cfg.get('evaluation') or {}
    eval_fn = None
    if not args.no_validate and evaluation.get('interval'):
        eval_fn = make_dataset_eval_fn(build_dataset(cfg.data['val']),
                                       batch_size, logger,
                                       resolve_compute_dtype(cfg))
    ckpt_cfg = cfg.get('checkpoint_config') or {}
    # self-describing checkpoints: the config text, CLASSES and versions
    meta = dict(
        config=cfg.dump(),
        config_file=os.path.basename(args.config),
        CLASSES=list(getattr(dataset, 'CLASSES', []) or []),
        demf_tpu_torch_version=__version__,
        torch_version=str(torch.__version__),
        seed=args.seed,
        time=time.strftime('%Y-%m-%d %H:%M:%S'))
    runner = Runner(
        model, optimizer, step, loader,
        max_epochs=cfg.runner['max_epochs'],
        log_interval=(cfg.get('log_config') or {}).get('interval', 50),
        checkpoint_interval=ckpt_cfg.get('interval', 1),
        max_keep_ckpts=ckpt_cfg.get('max_keep_ckpts', -1),
        work_dir=cfg.work_dir, seed=args.seed, logger=logger,
        eval_fn=eval_fn,
        eval_interval=0 if eval_fn is None else evaluation['interval'],
        meta=meta)
    if args.resume_from:
        runner.resume(args.resume_from)
        logger(f'resumed from {args.resume_from}')
    runner.run()
    if runner.epoch_s:
        logger(f'epochs took {runner.epoch_s:.3f} s, of which '
               f'{runner.loader_wait_s:.3f} s '
               f'({runner.loader_wait_s / runner.epoch_s:.1%}) waiting for '
               f'the loader')
    logger('training finished')


def main(argv=None):
    args = parse_args(argv)
    device, grouped = setup_device(args)
    try:
        if args.deterministic:
            set_deterministic()
        cfg = (Config.fromfile(args.config) if os.path.exists(args.config)
               else zoo.load_model_cfg(args.config))
        if args.cfg_options:
            cfg.merge_from_dict(args.cfg_options)
        if args.synthetic:
            train_synthetic(cfg, args, device)
        else:
            train_dataset(cfg, args, device)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
