"""Train DeMF-VoteNet with the port, on synthetic batches.

    python -m demf_tpu_torch.train configs/demf/demf_votenet.py --steps 3

Builds the detector (seeded random weights), its AdamW and its train step
from the config (``zoo.build_trainer``), makes one synthetic batch with
``zoo.synth_demf_batch``, fills its frozen image-branch features once
(``engine.feature_cache.compute_image_features``) and takes ``--steps``
steps on it through ``engine.Runner``, logging every step; ``--profile``
then traces one more step with ``torch.profiler`` and prints its kernels by
device time and the device's busy share of the step.  Reading the
dataset is not ported yet; until it is, this is the port's counterpart of
the repository's ``train.py``.  It runs on the GPU by default and stops
when there is none; ``--device cpu`` takes the plain versions of the
kernels (for small sizes only).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from demf_tpu.utils.config import Config

from . import zoo
from .engine import Runner, batch_to_device, compute_image_features
from .engine.trainer import PHASES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config', help='config file, or a path under configs/')
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--points', type=int, default=20000)
    p.add_argument('--hw', type=int, nargs=2, default=(800, 1344))
    p.add_argument('--gt', type=int, default=64, help='GT box slots')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--work-dir', default=None,
                   help='write a checkpoint here at the end')
    p.add_argument('--profile', action='store_true',
                   help='trace one more step and print where it spends')
    return p.parse_args(argv)


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


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this trainer runs on the GPU '
                         '(pass --device cpu for a small run on the CPU)')
    cfg = (Config.fromfile(args.config) if os.path.exists(args.config)
           else zoo.load_model_cfg(args.config))
    model, optimizer, step = zoo.build_trainer(cfg, device, args.seed)
    batch = batch_to_device(zoo.synth_demf_batch(
        args.batch, p=args.points, g=args.gt, hw=tuple(args.hw),
        seed=args.seed), device)
    t0 = time.perf_counter()
    batch['img_features'] = compute_image_features(model, batch)
    del batch['img']
    _sync(device)
    print(f'image features of {args.batch} scenes cached in '
          f'{time.perf_counter() - t0:.3f} s')
    runner = Runner(model, optimizer, step, [batch] * args.steps,
                    log_interval=1, work_dir=args.work_dir, seed=args.seed)
    runner.run()
    if args.profile:
        profile_step(step, batch, runner.generator, device)


if __name__ == '__main__':
    main()
