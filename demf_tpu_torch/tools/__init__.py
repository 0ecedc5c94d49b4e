"""Probes of the port's standalone kernels, run on the card:

    python -m demf_tpu_torch.tools.bench_gather_kernel [--small]   # K5
    python -m demf_tpu_torch.tools.bench_msda_matmul               # K7
    python -m demf_tpu_torch.tools.bench_msda_fold [--batch B]     # K5 + K6
    python -m demf_tpu_torch.tools.compare_kernels [--parent DIR]  # K1-K4,
                                                      # K6, K7, K9-K12
    python -m demf_tpu_torch.tools.k4_phases [--batch B]           # K4 by phase
    python -m demf_tpu_torch.tools.k12_phases                      # K12 by phase

Ports of the JAX package's ``tools/bench_gather_kernel.py``,
``tools/bench_msda_matmul.py`` and ``tools/bench_msda_layer.py::main18``.
Each checks its kernel against the plain version on the kernel's own
output, then times both with CUDA events, prints its lines and returns
the numbers.  Inputs come from a seeded generator on the card.  Without a
card each raises: none falls back to the CPU.  ``compare_kernels`` times
K1-K4, K6, K7 and K9-K12 in turns with another commit's, each through its own
wrapper.
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


# published peaks of one NVIDIA H100 SXM: float32 outside the tensor cores,
# bf16 on the tensor cores (dense; bf16 operands, float32 sums), and device
# memory
PEAK_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops, nbytes, peak_flops=PEAK_FLOPS):
    """The least time the card could take for work of ``flops`` operations
    at ``peak_flops`` (float32 by default; ``PEAK_BF16_FLOPS`` for
    multiply-adds of bf16 operands) that must move ``nbytes`` (each input
    read once, each output written once): (ms, 'operations' or 'bytes'),
    whichever is larger."""
    by_ops = flops / peak_flops * 1e3
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, 'operations') if by_ops > by_bytes else (by_bytes, 'bytes')


def msda_rows_touched(spatial_shapes, sampling_locations):
    """How many distinct (scene, token, head) value rows the bilinear
    corners of these sampling locations read (corners outside the map read
    nothing): the part of ``value`` that MSDA needs for this input."""
    b, q, heads, _, _, _ = sampling_locations.shape
    s = sum(h * w for h, w in spatial_shapes)
    hit = torch.zeros(b * s * heads, dtype=torch.bool,
                      device=sampling_locations.device)
    scene = torch.arange(b, device=hit.device)[:, None, None, None]
    head = torch.arange(heads, device=hit.device)[None, None, :, None]
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl]            # (B, Q, heads, P, 2)
        x0 = torch.floor(loc[..., 0] * w - 0.5).long()
        y0 = torch.floor(loc[..., 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                row = ((scene * s + start + y * w + x) * heads + head)[ok]
                hit[row] = True
        start += h * w
    return int(hit.sum())


def box_pairs_in_reach(points, boxes, eps=1e-6, chunk=1 << 22):
    """How many (point, box) pairs of each scene the count of points in
    boxes must test for these inputs: the point within the box's bounding
    circle ``sqrt(hx^2 + hy^2)`` in xy and within its half height in z
    (``h = dims / 2 + eps``), in float64; the pairs a culled count cannot
    leave out."""
    b, p = points.shape[:2]
    n = boxes.shape[1]
    pts = points[..., :3].double()
    bx = boxes.double()
    centre = torch.cat([bx[..., :2], bx[..., 2:3] + bx[..., 5:6] / 2], -1)
    half = bx[..., 3:6] / 2 + eps
    reach = half[..., 0] ** 2 + half[..., 1] ** 2                # (B, N)
    total = 0
    step = max(1, chunk // max(1, b * n))
    for i in range(0, p, step):
        d = pts[:, i:i + step, None] - centre[:, None]           # (B, c, N, 3)
        near = ((d[..., 0] ** 2 + d[..., 1] ** 2 <= reach[:, None]) &
                (d[..., 2].abs() <= half[:, None, :, 2]))
        total += int(near.sum())
    return total


def device_kernels(fn, runs=4):
    """The kernels one call of ``fn`` launches on the card, by torch.profiler
    over ``runs`` calls after one unprofiled (a window of one call can lose
    its first kernel): {function name: (launches a call, device ms a
    call)}."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = re.findall(r'([A-Za-z_]\w*)(?:<[^()]*>)?\(', e.key)
        name = name[0] if name else e.key
        n, ms = out.get(name, (0.0, 0.0))
        out[name] = (n + e.count / runs,
                     ms + e.self_device_time_total / 1e3 / runs)
    return out


def call_bytes(fn):
    """Device memory that one call of ``fn`` takes at its peak beyond what
    was allocated before it, its outputs included."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def bf16_err(got, want, rel_each, rel_max):
    """(max |got - want| - rel_each |want|, rel_max max |want|), compared in
    float32: within the bound when the first is at most the second."""
    got, want = got.float(), want.float()
    return (((got - want).abs() - rel_each * want.abs()).max().item(),
            rel_max * want.abs().max().item())


def max_err(got, want):
    """(max |got - want|, 1e-5 * max |want|), compared in float32."""
    want = want.float()
    return ((got.float() - want).abs().max().item(),
            1e-5 * want.abs().max().item())


def encoder_sampling_locations(spatial_shapes, b, heads, points, device,
                               jitter=0.5, seed=0):
    """Sampling locations as the deformable encoder's self-attention makes
    them, (B, sum_HW, heads, L, P, 2): query i is token i, its reference
    point is its own pixel's centre on every level, and its offsets are the
    DETR grid (head h's direction, point p at p + 1 pixels:
    ``models.transformer.msda_offset_bias_init``) plus normal noise of
    ``jitter`` pixels."""
    from ..models.transformer import msda_offset_bias_init
    levels = len(spatial_shapes)
    gen = torch.Generator(device).manual_seed(seed)
    ref = []
    for h, w in spatial_shapes:
        ys, xs = torch.meshgrid(
            (torch.arange(h, device=device) + 0.5) / h,
            (torch.arange(w, device=device) + 0.5) / w, indexing='ij')
        ref.append(torch.stack([xs, ys], -1).reshape(h * w, 2))
    ref = torch.cat(ref)                                   # (S, 2)
    grid = torch.from_numpy(msda_offset_bias_init(heads, levels, points))
    grid = grid.reshape(heads, levels, points, 2).to(device)
    s = ref.shape[0]
    offsets = grid + jitter * torch.randn(
        (b, s, heads, levels, points, 2), generator=gen, device=device)
    wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                      dtype=torch.float32, device=device)
    return (ref[None, :, None, None, None, :] +
            offsets / wh[None, None, None, :, None, :]).contiguous()


DECODER_LOCATIONS = ('whole map', 'crowded', 'piled')


def decoder_sampling_locations(spatial_shapes, b, q, heads, points, device,
                               where='whole map', seed=0):
    """Sampling locations of queries that are not the tokens (a decoder's),
    (B, Q, heads, L, P, 2), drawn three ways: ``'whole map'`` uniform over
    the map and a tenth of it around (corners off the map too);
    ``'crowded'`` each sample within 3 pixels of the first level of one of
    16 centres of its scene (long lists on a few rows); ``'piled'`` every
    sample at one place, (0.43, 0.61) (four rows a level take every
    corner)."""
    levels = len(spatial_shapes)
    shape = (b, q, heads, levels, points, 2)
    gen = torch.Generator(device).manual_seed(seed)
    if where == 'whole map':
        return torch.rand(shape, generator=gen, device=device) * 1.2 - 0.1
    if where == 'piled':
        return torch.tensor([0.43, 0.61], device=device).expand(
            shape).contiguous()
    if where != 'crowded':
        raise ValueError(f'no locations {where!r}')
    centres = torch.rand((b, 16, 2), generator=gen, device=device) * 0.8 + 0.1
    pick = torch.randint(0, 16, shape[:-1], generator=gen, device=device)
    at = torch.gather(centres, 1, pick.reshape(b, -1, 1).expand(-1, -1, 2))
    h0, w0 = spatial_shapes[0]
    px = torch.tensor([1.0 / w0, 1.0 / h0], device=device)
    noise = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * 3 * px
    return (at.reshape(shape) + noise).contiguous()
