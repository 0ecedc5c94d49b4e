"""Probes of the port's standalone kernels, run on the card:

    python -m demf_tpu_torch.tools.bench_gather_kernel [--small]   # K5
    python -m demf_tpu_torch.tools.bench_msda_matmul               # K7
    python -m demf_tpu_torch.tools.bench_msda_fold [--batch B]     # K5 + K6

Ports of the JAX package's ``tools/bench_gather_kernel.py``,
``tools/bench_msda_matmul.py`` and ``tools/bench_msda_layer.py::main18``.
Each checks its kernel against the plain version on the kernel's own
output, then times both with CUDA events, prints its lines and returns
the numbers.  Inputs come from a seeded generator on the card.  Without a
card each raises: none falls back to the CPU.
"""
from __future__ import annotations

import subprocess

import torch


def cuda_device():
    """The first CUDA device; raises without one.  Prints the card's name
    and power limit."""
    if not torch.cuda.is_available():
        raise RuntimeError('this probe measures the CUDA kernels and needs '
                           'an NVIDIA GPU')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        'nvidia-smi failed')
    print(f'device: {torch.cuda.get_device_name(0)} ({limit})', flush=True)
    return torch.device('cuda', 0)


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want):
    """(max |got - want|, 1e-5 * max |want|), compared in float32."""
    want = want.float()
    return ((got.float() - want).abs().max().item(),
            1e-5 * want.abs().max().item())
