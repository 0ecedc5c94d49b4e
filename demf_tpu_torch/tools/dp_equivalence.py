"""Data-parallel equivalence: ranks that train on their rows of a global
batch against one process that trains on the whole batch.

    python -m demf_tpu_torch.tools.dp_equivalence <config> [--world 2]
        [--device cpu|cuda] [--backend gloo|nccl] [--steps 2] [--batch 4]
        [--points 1024] [--hw H W] [--gt G] [--threads 2]

starts ``--world`` ranks (subprocesses of this module joined over a free
localhost port; every rank on ``cuda:0`` with ``--device cuda``, which
only gloo allows on one card), each taking ``--steps`` train steps on its
rows of the synthetic global batch of ``zoo.synth_batch_for`` (every
dropout rate 0), and the same steps in this process on the whole batch;
then prints how far the ranks' parameters are from each other (they must
be the same bits) and from the one-process run, and the first step's
loss, gradients and running statistics beside the one-process run's.
``run_ranks``, ``train_steps`` and ``compare`` are what the tests and
``chip_smoke.py`` call.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def without_dropout(cfg):
    """A copy of a config (dicts / lists) with every ``*dropout`` rate 0."""
    if isinstance(cfg, dict):
        return {k: (0.0 if k.endswith('dropout') and
                    isinstance(v, (int, float)) else without_dropout(v))
                for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(without_dropout(v) for v in cfg)
    return cfg


def load_cfg(config):
    """The config at ``config`` (a path, or one under ``configs/``) as a
    plain dict, every dropout rate 0."""
    from .. import zoo
    from ..utils.config import Config
    path = config if os.path.exists(config) else os.path.join(zoo.CFG_DIR,
                                                              config)
    cfg = Config.fromfile(path)
    return without_dropout({k: copy.deepcopy(cfg[k]) for k in cfg.keys()})


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _reversed(batch):
    """A batch (nested dicts / tuples of arrays) with its scenes in reverse
    order."""
    if isinstance(batch, dict):
        return {k: _reversed(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_reversed(v) for v in batch)
    return batch[::-1].copy() if getattr(batch, 'ndim', 0) else batch


def train_steps(cfg, device, steps=2, batch=None, points=1024, hw=None,
                gt=None, seed=0, dtype=torch.float32, reverse=False):
    """``steps`` train steps of ``cfg``'s model on this rank's rows of the
    synthetic global batch (all of it without a process group), in
    ``dtype`` (float64: the model, its statistics and the scenes); with
    ``reverse`` the global batch's scenes in reverse order (every scene's
    own computation the same, the sums over scenes in another order: the
    float32 noise of regrouping them, as the split over ranks does).
    Returns
    dict(params: state_dict after the steps, grads: the first step's
    gradients as the optimizer saw them (summed over the ranks, clipped),
    stats: the BatchNorm buffers after the first step, losses: each step's
    metrics (the global ones), step_s, all_reduce_s: the host seconds of
    each step (synchronized) and of its gradient all-reduce phase,
    collective_s / collectives: each step's seconds in all-reduces (that
    phase's and the statistics' and normalizers' in the forward and
    backward, each timed from a synchronize to a synchronize) and their
    count, launches: each step's launches of the port's kernels)."""
    from .. import ops, zoo
    from ..engine import batch_to_device, compute_image_features
    from ..parallel import rank_and_world, replicate, shard_batch
    from ..parallel.dist import rank_seed
    from ..utils.precision import cast_floating
    model, optimizer, step = zoo.build_trainer(cfg, device, seed)
    model.to(dtype)
    replicate(model)
    scenes = zoo.synth_batch_for(model, batch, p=points, g=gt, hw=hw,
                                 seed=seed)
    rows = shard_batch(_reversed(scenes) if reverse else scenes)
    rows = cast_floating(batch_to_device(rows, device), dtype)
    if getattr(model, 'caches_img_features', False) and \
            model.freeze_img_branch:
        rows['img_features'] = compute_image_features(model, rows)
        rows.pop('img')
    rank, world = rank_and_world()
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(seed, rank, world))
    record = dict(losses=[], step_s=[], all_reduce_s=[], launches=[],
                  collective_s=[], collectives=[])
    kernels = ops.kernels()
    first = {}
    optimizer_step = optimizer.step

    def snapshot_step(*args, **kwargs):
        if not first:
            first['grads'] = {n: p.grad.detach().cpu().clone()
                              for n, p in model.named_parameters()
                              if p.grad is not None}
        return optimizer_step(*args, **kwargs)

    optimizer.step = snapshot_step
    from ..parallel import dist as pdist
    sum_gradients = pdist.sum_gradients
    reduce_s = []

    def timed_sum(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = sum_gradients(*args, **kwargs)
        _sync(device)
        reduce_s.append(time.perf_counter() - t0)
        return out

    import torch.distributed as dist
    all_reduce = dist.all_reduce
    spent = []

    def timed_all_reduce(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = all_reduce(*args, **kwargs)
        _sync(device)
        spent.append(time.perf_counter() - t0)
        return out

    from ..engine import trainer
    trainer.sum_gradients = timed_sum
    dist.all_reduce = timed_all_reduce
    try:
        for i in range(steps):
            _sync(device)
            before = {n: k.launches for n, k in kernels.items()}
            spent.clear()
            t0 = time.perf_counter()
            metrics = step(rows, gen)
            _sync(device)
            record['step_s'].append(time.perf_counter() - t0)
            record['collective_s'].append(sum(spent))
            record['collectives'].append(len(spent))
            record['launches'].append({n: k.launches - before[n]
                                       for n, k in kernels.items()})
            record['losses'].append({k: float(v) for k, v in
                                     metrics.items()})
            if i == 0:
                record['stats'] = {n: b.detach().cpu().clone() for n, b in
                                   model.named_buffers()
                                   if 'running' in n}
    finally:
        trainer.sum_gradients = sum_gradients
        dist.all_reduce = all_reduce
        optimizer.step = optimizer_step
    record['all_reduce_s'] = reduce_s
    record['grads'] = first.get('grads', {})
    record['params'] = {n: p.detach().cpu().clone()
                        for n, p in model.state_dict().items()}
    return record


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(cases, world=2, device='cpu', backend='gloo', steps=2,
              dtypes=('float32',), seed=0, threads=2, timeout=600, env=None,
              work_dir=None):
    """``world`` ranks of this module's worker, each a subprocess joined
    over gloo (or ``backend``) at a free localhost port, each running
    ``train_steps`` for every case (dict(config, and ``train_steps``'s
    batch / points / hw / gt)) in each of ``dtypes``, from a fresh model;
    returns, in rank order, a list a rank of {dtype name: record} a case.
    The records pass through a temporary directory under ``work_dir``.
    Raises with a rank's output when one fails; kills the others."""
    init = f'tcp://127.0.0.1:{_free_port()}'
    env = dict(os.environ if env is None else env)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(world)]
        argv = ['--cases', json.dumps(cases), '--device', device,
                '--backend', backend, '--steps', str(steps), '--seed',
                str(seed), '--threads', str(threads), '--init', init,
                '--world', str(world), '--dtypes', *dtypes]
        procs = [subprocess.Popen(
            [sys.executable, '-m', 'demf_tpu_torch.tools.dp_equivalence'] +
            argv + ['--rank', str(r), '--out', outs[r]], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f'rank {r} of {world} exited with '
                                   f'{p.returncode}:\n{log[-4000:]}')
        return [torch.load(o, weights_only=False) for o in outs]


def run_case(case, device, steps=2, seed=0, dtype=torch.float32,
             reverse=False):
    """``train_steps`` of a case of ``run_ranks`` in this process."""
    kw = {k: v for k, v in case.items() if k != 'config'}
    return train_steps(load_cfg(case['config']), torch.device(device), steps,
                       seed=seed, dtype=dtype, reverse=reverse, **kw)


def _rel(got, want):
    """Largest |got - want| of the largest |want| (float64)."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


def compare(one, ranks):
    """How the ranks' records stand to each other and to one process's:
    dict(same_bits: names of the parameters / buffers that differ between
    ranks (empty when all are the same bits), params: (name, rel error) the
    largest of the parameters' |rank 0 - one process| of each tensor's
    largest, loss: the first step's loss's relative difference, grads and
    stats: (name, error) the largest first-step gradient / running-statistic
    difference of each tensor's largest, allclose: the names whose final
    parameters fail rtol 2e-5 / atol 2e-6 against the one-process run)."""
    first = ranks[0]
    same = sorted({n for r in ranks[1:] for n, t in r['params'].items()
                   if not torch.equal(t, first['params'][n])})
    params = max(((n, _rel(t, one['params'][n])) for n, t in
                  first['params'].items() if t.is_floating_point()),
                 key=lambda r: r[1])
    close = sorted(n for n, t in first['params'].items()
                   if t.is_floating_point() and not torch.allclose(
                       t, one['params'][n], rtol=2e-5, atol=2e-6))
    loss = abs(first['losses'][0]['loss'] - one['losses'][0]['loss']) / \
        max(abs(one['losses'][0]['loss']), 1e-30)
    if set(first['grads']) != set(one['grads']):
        raise AssertionError('the ranks and one process train other tensors')
    grads = max(((n, _rel(g, one['grads'][n])) for n, g in
                 first['grads'].items()), key=lambda r: r[1])
    stats = max(((n, _rel(s, one['stats'][n])) for n, s in
                 first['stats'].items()), key=lambda r: r[1],
                default=('', 0.0))
    return dict(same_bits=same, params=params, loss=loss, grads=grads,
                stats=stats, allclose=close)


def _worker(args):
    import torch.distributed as dist
    torch.set_num_threads(args.threads)
    device = torch.device(args.device)
    if device.type == 'cuda':
        device = torch.device('cuda', device.index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(device)
    dist.init_process_group(args.backend, init_method=args.init,
                            world_size=args.world, rank=args.rank)
    try:
        torch.save([{name: run_case(case, device, args.steps, args.seed,
                                    getattr(torch, name))
                     for name in args.dtypes}
                    for case in json.loads(args.cases)], args.out)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('config', nargs='?')
    parser.add_argument('--world', type=int, default=2)
    parser.add_argument('--device', default='cpu')
    parser.add_argument('--backend', default='gloo')
    parser.add_argument('--steps', type=int, default=2)
    parser.add_argument('--batch', type=int, default=None)
    parser.add_argument('--points', type=int, default=1024)
    parser.add_argument('--hw', type=int, nargs=2, default=None)
    parser.add_argument('--gt', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--threads', type=int, default=2)
    parser.add_argument('--dtypes', nargs='+', default=['float32'],
                        choices=['float32', 'float64'])
    parser.add_argument('--cases', help=argparse.SUPPRESS)
    parser.add_argument('--rank', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--init', help=argparse.SUPPRESS)
    parser.add_argument('--out', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _worker(args)
    case = dict(config=args.config, batch=args.batch, points=args.points,
                hw=args.hw, gt=args.gt)
    ranks = run_ranks([case], args.world, args.device, args.backend,
                      args.steps, args.dtypes, args.seed, args.threads)
    torch.set_num_threads(args.threads)
    results = {}
    for name in args.dtypes:
        one = run_case(case, args.device, args.steps, args.seed,
                       getattr(torch, name))
        mine = [r[0][name] for r in ranks]
        result = results[name] = compare(one, mine)
        print(f'{args.config} in {name}: {args.world} ranks on '
              f'{args.device} over {args.backend}, {args.steps} steps: '
              f'parameters that differ between ranks '
              f'{result["same_bits"] or "none"}; against one process: '
              f'parameters {result["params"]}, first loss '
              f'{result["loss"]:.3e}, gradients {result["grads"]}, running '
              f'statistics {result["stats"]}; outside rtol 2e-5 / atol '
              f'2e-6: {len(result["allclose"])} tensors; step s '
              f'{[round(s, 4) for s in mine[0]["step_s"]]} (one process '
              f'{[round(s, 4) for s in one["step_s"]]}), all-reduce s '
              f'{[round(s, 4) for s in mine[0]["all_reduce_s"]]}')
    return results


if __name__ == '__main__':
    main()
