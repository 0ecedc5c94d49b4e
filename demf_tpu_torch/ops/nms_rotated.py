"""Class-wise rotated 3D NMS over one IoU matrix a scene: CUDA kernel K15
and its plain version.

What ``demf_tpu/models/fcaf3d.py::get_bboxes`` does for each scene: one
rotated IoU matrix over the top-``nms_pre`` candidates
(``core/rotated_iou.py::iou3d_matrix``), then one greedy sweep a class
(``ops/nms.py::_greedy_suppress``), each in its class's own score order,
over that one matrix.  A candidate takes part in class c's sweep when it is
valid and its score of class c is above ``score_thr``.

A CUDA tensor launches K15 (``csrc/nms3d_rotated.cu``, one call, two
kernels: the IoUs of the pairs of boxes that take part, each pair once,
culled where the boxes cannot meet, into bits above ``iou_thr``; then a
block a (class, scene) that orders its class by counting and sweeps it, 32
boxes a step); a CPU tensor takes the plain version, ``iou3d_matrix`` and
``ops/nms.py::greedy_suppress`` class by class.  The kernel writes the IoU
matrix only when given one (the checks; every pair then), and the model
path gives none.  The kernel's IoUs agree with ``iou3d_matrix``'s to the
roundings of the transcendentals and of the sums' order; its masks equal
the plain sweep fed the kernel's own IoUs bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.rotated_iou import iou3d_matrix
from ._cuda import SMEM_PER_BLOCK, CudaKernel, check_cuda
from .nms import greedy_suppress

# boxes, scores, valid, iou (or null), bits (scratch the call zeroes),
# keep; B, N, classes; iou_thr, score_thr
NMS3D_ROTATED_KERNEL = CudaKernel(
    'demf_nms3d_rotated', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 +
    [ctypes.c_float] * 2)


def rotated_nms_classwise(boxes, scores, valid, iou_thr, score_thr):
    """boxes (B, N, 7), scores (B, N, C), valid (B, N) -> keep (B, C, N)
    bool: class c's greedy sweep over the one rotated IoU matrix of each
    scene.  A CPU tensor takes the plain version; a CUDA tensor launches
    K15 or raises."""
    if boxes.device.type == 'cpu':
        return rotated_nms_classwise_plain(boxes, scores, valid, iou_thr,
                                           score_thr)
    return rotated_nms_classwise_cuda(
        boxes.contiguous(), scores.contiguous(), valid.contiguous(), iou_thr,
        score_thr)


def classwise_sweep(iou, scores, valid, iou_thr, score_thr):
    """The greedy sweep of every class over the IoU matrix (B, N, N)
    -> keep (B, C, N)."""
    keeps = []
    for c in range(scores.shape[-1]):
        sc = scores[..., c]
        part = valid & (sc > score_thr)
        keeps.append(greedy_suppress(iou, sc, iou_thr, part) & part)
    return torch.stack(keeps, 1)


def rotated_nms_classwise_plain(boxes, scores, valid, iou_thr, score_thr):
    """``iou3d_matrix``, then ``greedy_suppress`` class by class."""
    return classwise_sweep(iou3d_matrix(boxes, boxes), scores, valid,
                           iou_thr, score_thr)


def sweep_shared_bytes(n):
    """Shared memory of K15's sweep block for N candidates (as
    ``csrc/nms3d_rotated.cu::sweep_shared_bytes``): the scene's bits (rows
    at an odd stride), the class's keys (later its steps' masks), its order
    and its kept mask."""
    w = (n + 31) // 32
    return 4 * (n * (w | 1) + 2 * n + w)


def rotated_nms_classwise_cuda(boxes, scores, valid, iou_thr, score_thr,
                               iou=None):
    """Kernel K15 (csrc/nms3d_rotated.cu): float32 boxes (B, N, 7) and
    scores (B, N, C), bool valid (B, N), contiguous on the card -> keep
    (B, C, N).  With ``iou``, a float32 (B, N, N) tensor on the card, the
    kernel also writes every pair's IoU there.  Raises when a scene's
    bits do not fit a block's shared memory (N above 1,312)."""
    check_cuda('boxes', boxes, torch.float32, 3)
    check_cuda('scores', scores, torch.float32, 3)
    check_cuda('valid', valid, torch.bool, 2)
    b, n, classes = scores.shape
    if boxes.shape != (b, n, 7) or valid.shape != (b, n):
        raise ValueError(
            f'boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)} and '
            f'valid {tuple(valid.shape)} do not go together')
    if iou is not None:
        check_cuda('iou', iou, torch.float32, 3)
        if iou.shape != (b, n, n):
            raise ValueError(f'iou {tuple(iou.shape)} is not ({b}, {n}, '
                             f'{n})')
    if sweep_shared_bytes(n) > SMEM_PER_BLOCK:
        raise ValueError(
            f'{n} candidates a scene need {sweep_shared_bytes(n)} bytes of '
            f'shared memory, a block has {SMEM_PER_BLOCK}')
    dev = boxes.device
    keep = torch.empty((b, classes, n), dtype=torch.bool, device=dev)
    if keep.numel():
        # each row's bits: the boxes it suppresses
        bits = torch.empty(b * n * ((n + 31) // 32), dtype=torch.int32,
                           device=dev)
        NMS3D_ROTATED_KERNEL(boxes.data_ptr(), scores.data_ptr(),
                             valid.data_ptr(),
                             0 if iou is None else iou.data_ptr(),
                             bits.data_ptr(), keep.data_ptr(), b, n, classes,
                             float(iou_thr), float(score_thr))
    return keep
