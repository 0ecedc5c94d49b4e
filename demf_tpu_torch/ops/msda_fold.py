"""MSDA weighted slot fold: CUDA kernel K6 and its plain version.

``out[bh, q, j] = sum_lp sum_slot rows[bh, lp, q, slot*hd + j] *
w[bh, lp, q, slot]``, accumulated in float32.  Ports of
``demf_tpu/ops/pallas/msda_fold.py::weighted_slot_fold`` and
``::weighted_slot_fold_batched`` (weights (LP, Q, 4), rounded to the rows'
dtype as there) and of ``tools/bench_msda_layer.py::main18.pallas_fold``
(``slot_major_fold``: weights (LP, 4, Q) in float32).  The TPU kernels'
``block`` and ``interpret`` arguments have no counterpart.

The JAX ``weighted_slot_fold`` also forms ``rows * w`` in the rows' dtype,
so with bf16 rows it rounds every product to bf16; the port keeps each
product in float32, as main18 does.  Both paths here round each product
and each sum in float32 in lp-major, then slot, order, so the kernel and
the plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import DTYPE_CODES, CudaKernel, check_cuda

MSDA_FOLD_KERNEL = CudaKernel(
    'demf_msda_fold', [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4)

# K6's vector kernel loads 16 bytes of a slot's channels a thread
VECTOR_BYTES = 16


def weighted_slot_fold(rows, w4, *, hd):
    """rows (LP, Q, 4*hd), w4 (LP, Q, 4) -> (Q, hd) float32."""
    return weighted_slot_fold_batched(rows[None], w4[None], hd=hd)[0]


def weighted_slot_fold_batched(rows, w4, *, hd):
    """rows (BH, LP, Q, 4*hd), w4 (BH, LP, Q, 4) -> (BH, Q, hd) float32;
    w4 is rounded to the rows' dtype first."""
    if rows.shape[-1] != 4 * hd:
        raise ValueError(f'rows {tuple(rows.shape)} are not 4 * hd = '
                         f'{4 * hd} wide')
    return slot_fold(rows, w4.to(rows.dtype))


def slot_major_fold(rows, w):
    """main18's layout: rows (LP, Q, 4*hd), w (LP, 4, Q) -> (Q, hd)
    float32, or with a leading BH on both.  The weights are read through
    their strides, not copied."""
    if rows.dim() == 3:
        return slot_major_fold(rows[None], w[None])[0]
    return slot_fold(rows, w.transpose(2, 3))


def slot_fold(rows, w):
    """rows (BH, LP, Q, 4*hd), w (BH, LP, Q, 4) of any strides ->
    (BH, Q, hd) float32.  A CPU tensor takes the plain version; a CUDA
    tensor launches K6 (rows and w in float32 or bfloat16)."""
    if rows.device.type == 'cpu':
        return slot_fold_plain(rows, w)
    return slot_fold_cuda(rows, w)


def slot_fold_plain(rows, w):
    """The same sums in the kernel's order: one float32 multiply and one
    add per (lp, slot)."""
    bh, lp, q, c4 = rows.shape
    hd = c4 // 4
    acc = torch.zeros((bh, q, hd), dtype=torch.float32, device=rows.device)
    for l in range(lp):
        for slot in range(4):
            r = rows[:, l, :, slot * hd:(slot + 1) * hd].float()
            acc = acc + r * w[:, l, :, slot, None].float()
    return acc


def fold_takes_vector_loads(rows):
    """Whether K6 takes these rows with its vector kernel, which loads 16
    bytes of one slot's channels a thread: hd must be a multiple of 8 in
    bfloat16 or 4 in float32 and the rows' data pointer 16-byte aligned.
    Other rows take its scalar kernel (one thread an output element).  The
    choice is made by shape and address before the launch, never on a
    failure."""
    lanes = VECTOR_BYTES // rows.element_size()
    return (rows.shape[-1] // 4) % lanes == 0 and \
        rows.data_ptr() % VECTOR_BYTES == 0


def weights_take_vector_loads(w):
    """Whether the vector kernel reads a (lp, q)'s 4 weights as one 8- or
    16-byte load: adjacent slots, and every (lp, q) on a grid of 4
    weights (the contiguous (BH, LP, Q, 4) layout)."""
    return w.stride(3) == 1 and all(st % 4 == 0 for st in w.stride()[:3]) \
        and w.data_ptr() % (4 * w.element_size()) == 0


def slot_fold_cuda(rows, w):
    """Kernel K6 (csrc/msda_fold.cu): the vector kernel where
    ``fold_takes_vector_loads(rows)``, else the scalar one."""
    if rows.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise TypeError(f'the fold kernel takes float32 or bfloat16 rows and '
                        f'weights, got {rows.dtype} and {w.dtype}')
    check_cuda('rows', rows, rows.dtype, 4)
    if not w.is_cuda:
        raise ValueError(f'w must be a CUDA tensor, got {w.device}')
    bh, lp, q, c4 = rows.shape
    if c4 % 4 or tuple(w.shape) != (bh, lp, q, 4):
        raise ValueError(f'w {tuple(w.shape)} does not match rows '
                         f'{tuple(rows.shape)} (4 slots of hd channels)')
    out = torch.empty((bh, q, c4 // 4), dtype=torch.float32,
                      device=rows.device)
    MSDA_FOLD_KERNEL(rows.data_ptr(), w.data_ptr(), out.data_ptr(), bh, lp,
                     q, c4 // 4, *w.stride(), DTYPE_CODES[rows.dtype],
                     DTYPE_CODES[w.dtype], int(fold_takes_vector_loads(rows)),
                     int(weights_take_vector_loads(w)))
    return out
