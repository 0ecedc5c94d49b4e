"""Furthest point sampling (FPS): CUDA kernel K1 and its plain version.

Port of ``demf_tpu/ops/sampling.py``.  The first pick is index 0, distances
are squared euclidean, the running min-distance decides the next pick and
ties go to the lowest index.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda

# csrc/fps.cu: a thread owns at most 16 points; 8 blocks of 256 threads hold
FPS_MAX_POINTS = 32 * 1024
FPS_KERNEL = CudaKernel('demf_fps', [ctypes.c_void_p, ctypes.c_void_p] +
                        [ctypes.c_int] * 5)


def fps_launch_shape(n):
    """(blocks in a scene's cluster, threads in a block) for N points.

    The cluster shares a scene's points, so more blocks shorten a step's
    pass over them and add an exchange between the blocks to it; the
    sizes are the fastest measured on an NVIDIA H100 at the shapes the
    models send, N 512 to 2,048 and 20,000 (``python -m
    demf_tpu_torch.tools.compare_kernels --sweep``), among the portable
    cluster sizes (up to 8).  Each thread owns
    ceil(ceil(N / cluster) / threads) <= 16 points.
    """
    if not 0 < n <= FPS_MAX_POINTS:
        raise ValueError(f'FPS kernel takes 1..{FPS_MAX_POINTS} points, '
                         f'got {n}')
    return (1, 128) if n <= 2048 else (8, 256)


def furthest_point_sample(points_xyz, num_samples):
    """(B, N, 3) float -> (B, K) int64 indices.

    A CPU tensor takes the plain version; a CUDA tensor the kernel.
    """
    if points_xyz.device.type == 'cpu':
        return furthest_point_sample_plain(points_xyz, num_samples)
    return furthest_point_sample_cuda(points_xyz.contiguous(), num_samples)


def furthest_point_sample_plain(points_xyz, num_samples):
    """The selection loop of ``_furthest_point_sample_xla`` in torch."""
    b, n, _ = points_xyz.shape
    xyz = points_xyz.float()
    dists = torch.full((b, n), 1e10, dtype=torch.float32,
                       device=xyz.device)
    idxs = torch.zeros((b, num_samples), dtype=torch.int64,
                       device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = xyz[:, 0]
    for k in range(1, num_samples):
        diff = xyz - last[:, None, :]
        # (dx*dx + dy*dy) + dz*dz: the kernel's rounding order
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + \
            diff[..., 2] * diff[..., 2]
        dists = torch.minimum(dists, d)
        nxt = torch.argmax(dists, -1)          # first maximum on ties
        idxs[:, k] = nxt
        last = xyz[rows, nxt]
    return idxs


def furthest_point_sample_cuda(points_xyz, num_samples):
    """Kernel K1 (csrc/fps.cu)."""
    check_cuda('points_xyz', points_xyz, torch.float32, 3)
    b, n, c = points_xyz.shape
    if c != 3:
        raise ValueError(f'points_xyz must be (B, N, 3), got {c} channels')
    cluster, threads = fps_launch_shape(n)
    if num_samples < 1:
        raise ValueError(f'num_samples must be >= 1, got {num_samples}')
    out = torch.empty((b, num_samples), dtype=torch.int64,
                      device=points_xyz.device)
    if b:
        FPS_KERNEL(points_xyz.data_ptr(), out.data_ptr(), b, n, num_samples,
                   cluster, threads)
    return out
