"""Row gather ``rows[bh, s] = plane[bh, idx[bh, s]]``: CUDA kernel K5 and
its plain version.

Port of ``demf_tpu/ops/pallas/gather_rows.py::gather_rows`` and of
``tools/bench_gather_kernel.py::pallas_gather``, which compute the same
function.  The TPU kernels' tiling arguments (``s_tile``, ``unroll``) and
their alignment rules have no counterpart: K5 takes any N and S.  Indices
are clamped to [0, N) on both paths, as JAX's gather clamps them.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda

GATHER_ROWS_KERNEL = CudaKernel(
    'demf_gather_rows', [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4)


def gather_rows(plane, idx):
    """plane (BH, N, C), idx (BH, S) integer -> rows (BH, S, C) in the
    plane's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches K5, which
    needs a row of whole 16-byte vectors (C % 128 == 0 does it for bf16 and
    f32) and int32 indices.
    """
    if plane.device.type == 'cpu':
        return gather_rows_plain(plane, idx)
    return gather_rows_cuda(plane, idx)


# the probe's select form computes the same function
pallas_gather = gather_rows


def gather_rows_plain(plane, idx):
    """Advanced indexing, bit-exact."""
    bh, n, _ = plane.shape
    rows = torch.arange(bh, device=plane.device)[:, None]
    return plane[rows, idx.long().clamp(0, n - 1)]


def gather_rows_cuda(plane, idx):
    """Kernel K5 (csrc/gather_rows.cu)."""
    check_cuda('plane', plane, plane.dtype, 3)
    check_cuda('idx', idx, torch.int32, 2)
    bh, n, c = plane.shape
    s = idx.shape[1]
    if idx.shape[0] != bh:
        raise ValueError(f'idx {tuple(idx.shape)} does not match plane '
                         f'{tuple(plane.shape)}')
    row_bytes = c * plane.element_size()
    if row_bytes % 16 or plane.data_ptr() % 16:
        raise ValueError(f'the gather kernel moves 16-byte vectors: a row of '
                         f'{c} x {plane.dtype} is {row_bytes} bytes')
    if n == 0 and s:
        raise ValueError('cannot gather from an empty plane')
    out = torch.empty((bh, s, c), dtype=plane.dtype, device=plane.device)
    GATHER_ROWS_KERNEL(plane.data_ptr(), idx.data_ptr(), out.data_ptr(), bh,
                       n, s, row_bytes)
    return out
