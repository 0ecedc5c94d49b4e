"""M-form MSDA sampling as a weighted gather-sum: CUDA kernel K7 and its
plain version.

Port of ``tools/bench_msda_matmul.py::mform_sample``:
``out[bh, q] = sum_k w16[bh, k, q] * plane[bh, idx16[bh, k, q]]``,
accumulated in float32 and returned in the plane's dtype.  The TPU kernel
forms this as a one-hot matrix times the plane on its matrix unit; K7
gathers the K rows instead, 16 bytes of a row a thread, and never builds
the matrix.  The tiling arguments ``q_t``, ``n_t`` and ``interpret`` have
no counterpart.  Indices are clamped to [0, N) on both paths, as JAX's
gather clamps them.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import DTYPE_CODES, SMEM_PER_BLOCK, CudaKernel, check_cuda

# csrc/mform_sample.cu: plane, idx, w, out; BH, N, K, Q, hd; dtype codes of
# plane and weights; queries a tile, threads a block
MFORM_KERNEL = CudaKernel(
    'demf_mform_sample', [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9)
MFORM_Q_TILE = 512
# a thread owns 16 bytes of a query's row at a time, and this many of a tile
MFORM_PIECES_A_THREAD = 4


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


def mform_smem_bytes(k, q_tile, w_size):
    """Shared memory of one block of the kernel: a tile's K x q_tile int32
    indices and weights."""
    return k * q_tile * (4 + w_size)


def mform_launch_shape(k, hd, plane_size=2, w_size=2):
    """(queries a tile, threads a block) for K slots, rows of hd elements
    of ``plane_size`` bytes and weights of ``w_size`` bytes.

    A block takes 512 queries and as many threads as give each 4 of the
    tile's 16-byte pieces of output, between 64 and 512 (512 at head_dim
    32 in bf16 and in f32): the fastest timed on an NVIDIA H100 at the
    encoder's four levels in both dtypes (``python -m
    demf_tpu_torch.tools.compare_kernels --sweep``).  The tile halves
    until its K slots fit a block's shared memory.  Raises where a row is
    no whole number of 16-byte pieces or 8 queries do not fit.
    """
    if hd < 1 or (hd * plane_size) % 16:
        raise ValueError(f'the M-form kernel reads rows in 16-byte pieces: '
                         f'head_dim {hd} x {plane_size} bytes is no multiple '
                         f'of 16')
    q_tile = MFORM_Q_TILE
    while mform_smem_bytes(k, q_tile, w_size) > SMEM_PER_BLOCK:
        if q_tile == 8:
            raise ValueError(f'M-form kernel: {k} slots of 8 queries do not '
                             f'fit a block\'s shared memory')
        q_tile //= 2
    pieces = q_tile * (hd * plane_size // 16)
    threads = -(-pieces // MFORM_PIECES_A_THREAD // 32) * 32
    return q_tile, min(max(threads, 64), 512)


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
    shape = mform_launch_shape(k, hd, plane.element_size(),
                               w16.element_size())
    out = torch.empty((bh, q, hd), dtype=plane.dtype, device=plane.device)
    if bh and q:
        MFORM_KERNEL(plane.data_ptr(), idx16.data_ptr(), w16.data_ptr(),
                     out.data_ptr(), bh, n, k, q, hd,
                     DTYPE_CODES[plane.dtype], DTYPE_CODES[w16.dtype], *shape)
    return out
