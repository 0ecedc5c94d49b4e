"""M-form MSDA sampling as a weighted gather-sum: CUDA kernel K7 and its
plain version.

Port of ``tools/bench_msda_matmul.py::mform_sample``:
``out[bh, q] = sum_k w16[bh, k, q] * plane[bh, idx16[bh, k, q]]``,
accumulated in float32 and returned in the plane's dtype.  The TPU kernel
forms this as a one-hot matrix times the plane on its matrix unit; K7
gathers the K rows instead and never builds the matrix.  The tiling
arguments ``q_t``, ``n_t`` and ``interpret`` have no counterpart.  Indices
are clamped to [0, N) on both paths, as JAX's gather clamps them.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import DTYPE_CODES, CudaKernel, check_cuda

MFORM_KERNEL = CudaKernel(
    'demf_mform_sample', [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)


def mform_sample(plane, idx16, w16):
    """plane (BH, N, hd), idx16 (BH, K, Q, 1) integer, w16 (BH, K, Q, 1)
    -> (BH, Q, hd) in the plane's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches K7 (plane
    and weights in float32 or bfloat16, int32 indices).
    """
    if plane.device.type == 'cpu':
        return mform_sample_plain(plane, idx16, w16)
    return mform_sample_cuda(plane, idx16, w16)


def mform_sample_plain(plane, idx16, w16):
    """One gather per k and a float32 multiply and add, in the kernel's
    order."""
    bh, n, hd = plane.shape
    idx = idx16[..., 0].long().clamp(0, n - 1)
    w = w16[..., 0]
    rows = torch.arange(bh, device=plane.device)[:, None]
    acc = torch.zeros((bh, idx.shape[2], hd), dtype=torch.float32,
                      device=plane.device)
    for k in range(idx.shape[1]):
        acc = acc + w[:, k, :, None].float() * plane[rows, idx[:, k]].float()
    return acc.to(plane.dtype)


def mform_sample_cuda(plane, idx16, w16):
    """Kernel K7 (csrc/mform_sample.cu)."""
    if plane.dtype not in DTYPE_CODES or w16.dtype not in DTYPE_CODES:
        raise TypeError(f'the M-form kernel takes float32 or bfloat16 planes '
                        f'and weights, got {plane.dtype} and {w16.dtype}')
    check_cuda('plane', plane, plane.dtype, 3)
    check_cuda('idx16', idx16, torch.int32, 4)
    check_cuda('w16', w16, w16.dtype, 4)
    bh, n, hd = plane.shape
    _, k, q, one = idx16.shape
    if idx16.shape[0] != bh or one != 1 or w16.shape != idx16.shape:
        raise ValueError(f'idx16 {tuple(idx16.shape)} and w16 '
                         f'{tuple(w16.shape)} must both be (BH, K, Q, 1) '
                         f'with BH = {bh}')
    if n == 0 and k and q:
        raise ValueError('cannot sample an empty plane')
    out = torch.empty((bh, q, hd), dtype=plane.dtype, device=plane.device)
    MFORM_KERNEL(plane.data_ptr(), idx16.data_ptr(), w16.data_ptr(),
                 out.data_ptr(), bh, n, k, q, hd, DTYPE_CODES[plane.dtype],
                 DTYPE_CODES[w16.dtype])
    return out
