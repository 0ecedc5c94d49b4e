"""Data parallelism over ranks (port of ``demf_tpu/parallel/mesh.py``).

The JAX package trains one GLOBAL batch under GSPMD: its batch statistics,
its loss normalizers and its gradient are those of the whole batch,
whatever the device count.  Here one process drives one card (a rank), and
the same global semantics are kept by hand:

* ``samples_per_gpu`` is the global batch; each rank takes its contiguous
  rows (``rows_of_rank``, ``shard_batch``), and the rank count must divide
  it (the JAX package shrinks its mesh to a divisor; a rank cannot be
  dropped, so the port refuses);
* every train-mode BatchNorm and every batch-wide loss normalizer goes
  through ``global_sum``, an all-reduce with autograd, so that each rank's
  loss is its share of the one-rank loss on the global batch and the
  statistics are the global batch's;
* after the backward the gradients are summed over ranks
  (``sum_gradients``, one flat bucket), so the clip, the schedule and the
  optimizer run on the same numbers on every rank;
* rank 0's parameters and buffers are broadcast once at the start
  (``replicate``).

Without a process group (or with one rank) every function here is the
identity or its one-rank form, and nothing is communicated.  The JAX
package's ``model`` mesh axis has no counterpart: no entry point or config
uses it.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.distributed as dist

LAUNCHERS = ('pytorch', 'slurm', 'mpi', 'jax')


def _expand_slurm_nodelist(nodelist):
    """First hostname of a SLURM nodelist (plain, comma, or ``n[01-04]``):
    the node that hosts the coordinator."""
    first = nodelist.split(',')[0].strip()
    m = re.match(r'^([^\[]*)\[([^\]\-,]+)', first)
    if m:
        return m.group(1) + m.group(2)
    return first


def resolve_launcher_env(launcher, environ):
    """A launcher's env vars -> dict(coordinator_address='host:port',
    num_processes, process_id), as the JAX package resolves them:

    - ``pytorch`` (``torchrun``, ``torch.distributed.launch``): RANK /
      WORLD_SIZE / MASTER_ADDR / MASTER_PORT;
    - ``slurm``: SLURM_PROCID / SLURM_NTASKS / SLURM_STEP_NODELIST (or
      SLURM_JOB_NODELIST / SLURM_NODELIST), the coordinator on the first
      node at MASTER_PORT or 29500;
    - ``mpi`` (Open MPI): OMPI_COMM_WORLD_RANK / OMPI_COMM_WORLD_SIZE and
      MASTER_ADDR / MASTER_PORT;
    - ``jax``: JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
      JAX_PROCESS_ID, so a launch script written for the JAX package runs
      unchanged; without them ``{}`` (the JAX package's auto-detection,
      which ``init_distributed`` refuses).

    Raises RuntimeError naming the launcher when its env is missing: never
    a quiet single-process run.
    """
    def need(*names):
        missing = [n for n in names if n not in environ]
        if missing:
            raise RuntimeError(
                f'--launcher {launcher}: missing env var(s) {missing}; '
                f'launch via the matching job launcher (torchrun, srun, '
                f'mpirun) or use --launcher jax with JAX_COORDINATOR_ADDRESS'
                f'/JAX_NUM_PROCESSES/JAX_PROCESS_ID')
        return [environ[n] for n in names]

    if launcher == 'pytorch':
        rank, world, addr, port = need('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                                       'MASTER_PORT')
        return dict(coordinator_address=f'{addr}:{port}',
                    num_processes=int(world), process_id=int(rank))
    if launcher == 'slurm':
        rank, world = need('SLURM_PROCID', 'SLURM_NTASKS')
        nodelist = (environ.get('SLURM_STEP_NODELIST')
                    or environ.get('SLURM_JOB_NODELIST')
                    or environ.get('SLURM_NODELIST'))
        if not nodelist:
            raise RuntimeError(
                '--launcher slurm: no SLURM_*_NODELIST env var; cannot '
                'locate the coordinator node')
        addr = _expand_slurm_nodelist(nodelist)
        port = environ.get('MASTER_PORT', '29500')
        return dict(coordinator_address=f'{addr}:{port}',
                    num_processes=int(world), process_id=int(rank))
    if launcher == 'mpi':
        rank, world = need('OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE')
        addr, port = need('MASTER_ADDR', 'MASTER_PORT')
        return dict(coordinator_address=f'{addr}:{port}',
                    num_processes=int(world), process_id=int(rank))
    kwargs = {}
    if environ.get('JAX_COORDINATOR_ADDRESS'):
        kwargs = dict(
            coordinator_address=environ['JAX_COORDINATOR_ADDRESS'],
            num_processes=int(environ['JAX_NUM_PROCESSES'])
            if environ.get('JAX_NUM_PROCESSES') else None,
            process_id=int(environ['JAX_PROCESS_ID'])
            if environ.get('JAX_PROCESS_ID') else None)
    return kwargs


# the env var of each launcher that names a process's card on its node
_LOCAL_RANK = dict(pytorch='LOCAL_RANK', slurm='SLURM_LOCALID',
                   mpi='OMPI_COMM_WORLD_LOCAL_RANK')


def init_distributed(launcher, device='cuda', backend=None, environ=None,
                     local_rank=None):
    """Join the process group that ``launcher``'s env describes and return
    this rank's device: ``cuda:<local rank>`` (made current) for a CUDA
    ``device``, else the CPU.  The backend is NCCL for a CUDA device and
    gloo for the CPU, unless ``backend`` names one (gloo on CUDA tensors
    stages through the host).  The local rank is the launcher's env var
    (LOCAL_RANK, SLURM_LOCALID, OMPI_COMM_WORLD_LOCAL_RANK), else
    ``local_rank`` (``torch.distributed.launch``'s ``--local_rank``), else
    the rank modulo the node's card count.  Raises where the env is
    missing, where the JAX package would auto-detect (TPU-VM metadata has
    no counterpart here), and where the init fails: nothing is retried on
    another backend."""
    if launcher not in LAUNCHERS:
        raise ValueError(f'--launcher {launcher!r}: one of {LAUNCHERS}')
    environ = os.environ if environ is None else environ
    kw = resolve_launcher_env(launcher, environ)
    if not kw or kw['num_processes'] is None or kw['process_id'] is None:
        raise RuntimeError(
            f'--launcher {launcher}: JAX_COORDINATOR_ADDRESS, '
            f'JAX_NUM_PROCESSES and JAX_PROCESS_ID must all be set; the JAX '
            f'package\'s auto-detection (TPU-VM metadata) has no '
            f'counterpart on a GPU host')
    rank, world = kw['process_id'], kw['num_processes']
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device: this entry point runs on the '
                             'GPU (pass --device cpu for a small run on the '
                             'CPU)')
        env_local = environ.get(_LOCAL_RANK.get(launcher, ''))
        if env_local is not None:
            local = int(env_local)
        elif local_rank is not None:
            local = int(local_rank)
        else:
            local = rank % torch.cuda.device_count()
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ('nccl' if device.type == 'cuda' else 'gloo'),
        init_method=f'tcp://{kw["coordinator_address"]}', world_size=world,
        rank=rank)
    return device


def rank_and_world():
    """(rank, world size) of the default process group, (0, 1) without."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_distributed():
    """True under a process group of more than one rank."""
    return rank_and_world()[1] > 1


def rank_seed(seed, rank, world):
    """The seed of a rank's generator: ``seed`` itself on one rank, else
    drawn from (``seed``, rank), so no two ranks draw the same numbers."""
    if world == 1:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def rows_of_rank(batch_size, rank, world):
    """The slice of a global batch of ``batch_size`` scenes that ``rank``
    of ``world`` takes: contiguous rows, in rank order.  Raises unless the
    rank count divides the batch."""
    if batch_size % world:
        raise ValueError(
            f'{world} ranks do not divide the global batch of {batch_size} '
            f'scenes (samples_per_gpu is the global batch, as in the JAX '
            f'package); choose a rank count that divides it')
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, rank=None, world=None):
    """This rank's rows of a global batch (nested dicts / tuples of numpy
    arrays or tensors, the batch axis first); the whole batch without a
    process group."""
    if rank is None:
        rank, world = rank_and_world()
    if world == 1:
        return batch

    def take(x, rows):
        if isinstance(x, dict):
            return {k: take(v, rows) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v, rows) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            return x[rows]
        return x

    sizes = {len(v) for v in _leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f'batch leaves of different lengths {sorted(sizes)}')
    return take(batch, rows_of_rank(sizes.pop(), rank, world))


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
        yield x


@torch.no_grad()
def replicate(module):
    """Broadcast rank 0's parameters and buffers to every rank (once, at
    the start: afterwards the summed gradients keep the ranks equal)."""
    if not is_distributed():
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)
    return module


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: each rank's
    input gets the sum of every rank's gradient of the result."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def global_sum(x):
    """``x`` summed over the ranks, with autograd (``_SumOverRanks``).  The
    identity without a process group."""
    if not is_distributed():
        return x
    return _SumOverRanks.apply(x)


def global_moments(x, dims, weight=None):
    """Mean and biased variance of ``x`` over the axes ``dims`` and every
    rank, each of shape ``x.shape[-1]`` or of the kept axis: the count and
    the sum in one all-reduce, then the sum of squared deviations about the
    global mean in another (not E[x^2] - mean^2, which loses float32 bits).
    ``weight`` (broadcast against ``x``, 0 or 1) keeps only its rows, the
    count at least 1.  With autograd through both sums."""
    if weight is None:
        count = x.new_full((1,), float(np.prod([x.shape[d] for d in dims])))
        xw = x
    else:
        count = weight.sum(dims).reshape(1).to(x.dtype)
        xw = x * weight
    sums = global_sum(torch.cat([xw.sum(dims).reshape(-1), count]))
    count = sums[-1:].clamp(min=1.0)
    mean = sums[:-1] / count
    shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    dev = (x - mean.reshape(shape)) ** 2
    if weight is not None:
        dev = dev * weight
    var = global_sum(dev.sum(dims).reshape(-1)) / count
    return mean, var


def mean_share(x):
    """This rank's share of the mean of ``x`` over the global batch: its
    sum over the global element count (every rank holds as many rows).
    The shares sum to the global mean; without a process group the mean."""
    _, world = rank_and_world()
    if world == 1:
        return x.mean()
    return x.sum() / (x.numel() * world)


def sum_gradients(params, extra=None):
    """Sum the gradients of ``params`` over the ranks in one flat bucket
    (float32, float64 for float64 parameters), together with the 1-d tensor
    ``extra`` (the step's metrics), and return the summed ``extra``.  A parameter whose gradient is None on
    every rank keeps None (the optimizer skips it, as it does on one rank);
    one that has a gradient on some rank gets the sum, zeros standing in for
    the ranks without.  Without a process group nothing moves."""
    if not is_distributed():
        return extra
    grads = [p.grad for p in params]
    some = next(g for g in grads if g is not None)
    dtype = torch.float32
    for p in params:
        dtype = torch.promote_types(dtype, p.dtype)
    parts = [(g if g is not None else torch.zeros_like(p)).reshape(-1).to(
        dtype) for p, g in zip(params, grads)]
    parts.append(torch.tensor([g is not None for g in grads], dtype=dtype,
                              device=some.device))
    if extra is not None:
        parts.append(extra.to(dtype).reshape(-1))
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    n = sum(p.numel() for p in params)
    present = flat[n:n + len(params)].tolist()
    offset = 0
    for p, has in zip(params, present):
        if has:
            p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
    if extra is None:
        return None
    return flat[n + len(params):].to(extra.dtype)


def gather_to_rank0(obj, collective=False, tmpdir=None):
    """Every rank's ``obj`` in rank order, on rank 0 (None elsewhere), as
    mmdet's ``multi_gpu_test`` collects: by a collective
    (``gather_object``; ``--gpu-collect``), or through one pickle a rank in
    ``tmpdir`` (``--tmpdir``; without it a fresh directory under
    ``.dist_test`` in the working directory, mmdet's default, removed
    afterwards), read by rank 0 behind a barrier; the pickles are removed
    after a second barrier."""
    rank, world = rank_and_world()
    if world == 1:
        return [obj]
    if collective:
        out = [None] * world if rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out
    import pickle
    import shutil
    import tempfile
    fresh = tmpdir is None
    if fresh:
        name = [None]
        if rank == 0:
            os.makedirs('.dist_test', exist_ok=True)
            name = [tempfile.mkdtemp(dir='.dist_test')]
        dist.broadcast_object_list(name, src=0)
        tmpdir = name[0]
    os.makedirs(tmpdir, exist_ok=True)
    with open(os.path.join(tmpdir, f'part_{rank}.pkl'), 'wb') as f:
        pickle.dump(obj, f)
    dist.barrier()
    out = None
    if rank == 0:
        out = []
        for r in range(world):
            path = os.path.join(tmpdir, f'part_{r}.pkl')
            with open(path, 'rb') as f:
                out.append(pickle.load(f))
    dist.barrier()
    if rank == 0:
        for r in range(world):
            os.remove(os.path.join(tmpdir, f'part_{r}.pkl'))
        if fresh:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return out
