"""Fixed-shape greedy 3D NMS, batched over B: CUDA kernel K8 and its plain
version.

Port of ``demf_tpu/ops/nms.py`` (``_greedy_suppress``, ``aligned_3d_nms``).
A CUDA tensor launches K8 (``csrc/nms3d.cu``): one launch for the whole
batch, one block a scene.  A CPU tensor takes the plain version, whose
greedy sweep is a Python loop of N steps.  ``aligned_3d_nms_bitmask`` is
K8's rule (the order by counting, a row of suppression bits a box, one
sweep over the order) written out in Python, so that the rule is tested
where the kernel cannot run.

What a NaN does, on every path: a pair whose IoU is NaN suppresses nothing
(``NaN > thresh`` is false), so a box with a NaN or infinite coordinate
neither suppresses nor is suppressed; a NaN score comes last in the order,
after the invalid boxes.  ``thresh`` must be >= 0: below 0 the plain
version's product with the class equality would let boxes of different
classes suppress each other.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import SMEM_PER_BLOCK, CudaKernel, check_cuda

NMS3D_KERNEL = CudaKernel(
    'demf_nms3d', [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 +
    [ctypes.c_float])


def greedy_suppress(iou, scores, thresh, valid):
    """Score-ordered greedy suppression over a precomputed IoU matrix.

    Args:
        iou: (B, N, N) pairwise IoU (already class-masked if needed).
        scores: (B, N).
        thresh: suppress when iou > thresh.
        valid: (B, N) bool; invalid entries are never kept.
    Returns:
        (B, N) bool keep mask in the original order.
    """
    b, n = scores.shape
    neg_inf = torch.full_like(scores, float('-inf'))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    iou_s = torch.gather(iou, 1, order[:, :, None].expand(-1, -1, n))
    iou_s = torch.gather(iou_s, 2, order[:, None, :].expand(-1, n, -1))
    later = torch.ones(n, n, dtype=torch.bool, device=iou.device).triu(1)
    sup = (iou_s > thresh) & later
    keep = torch.gather(valid, 1, order)
    for i in range(n):
        keep = keep & ~(keep[:, i:i + 1] & sup[:, i])
    return torch.zeros_like(keep).scatter(1, order, keep)


def pairwise_aligned_iou(boxes, classes):
    """(B, N, N) IoU of axis-aligned boxes (B, N, 6), 0 between classes.
    The three extents are multiplied as ``(dx * dy) * dz``, on any device
    (K8 repeats these roundings)."""
    lt = torch.maximum(boxes[:, :, None, :3], boxes[:, None, :, :3])
    rb = torch.minimum(boxes[:, :, None, 3:], boxes[:, None, :, 3:])
    d = (rb - lt).clamp_min(0)
    inter = d[..., 0] * d[..., 1] * d[..., 2]
    e = (boxes[..., 3:] - boxes[..., :3]).clamp_min(0)
    vol = e[..., 0] * e[..., 1] * e[..., 2]
    iou = inter / (vol[:, :, None] + vol[:, None, :] - inter).clamp_min(1e-8)
    return iou * (classes[:, :, None] == classes[:, None, :])


def aligned_3d_nms(boxes, scores, classes, thresh, valid=None):
    """Axis-aligned 3D NMS, same-class suppression only.

    boxes (B, N, 6) as (x1, y1, z1, x2, y2, z2), scores (B, N), classes
    (B, N) -> (B, N) bool keep mask, of any strides.  A CPU tensor takes
    the plain version; a CUDA tensor launches K8 (on contiguous copies
    where an input is a view, as VoteNet's sliced scores are) or raises.
    """
    if not thresh >= 0:
        raise ValueError(f'thresh must be >= 0, got {thresh}')
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    if boxes.device.type == 'cpu':
        return aligned_3d_nms_plain(boxes, scores, classes, thresh, valid)
    return aligned_3d_nms_cuda(boxes.contiguous(), scores.contiguous(),
                               classes.contiguous(), thresh,
                               valid.contiguous())


def aligned_3d_nms_plain(boxes, scores, classes, thresh, valid):
    """The IoU matrix, then the sweep as a loop of N steps."""
    return greedy_suppress(pairwise_aligned_iou(boxes, classes), scores,
                           thresh, valid)


def nms_shared_bytes(n):
    """Shared memory K8 needs for a scene of ``n`` boxes (as
    ``csrc/nms3d.cu::shared_bytes``): the suppression bits, N rows of
    N / 32 words, 45 bytes a box and a word of the removed mask for every
    32."""
    words = (n + 31) // 32
    return 8 * n + 4 * (n * words + 9 * n + words) + n


def aligned_3d_nms_cuda(boxes, scores, classes, thresh, valid):
    """Kernel K8 (csrc/nms3d.cu): float32 boxes and scores, int64 classes,
    bool valid, all contiguous on the card.  Raises when a scene's
    suppression bits do not fit a block's shared memory (N above 1,184)."""
    check_cuda('boxes', boxes, torch.float32, 3)
    check_cuda('scores', scores, torch.float32, 2)
    check_cuda('classes', classes, torch.int64, 2)
    check_cuda('valid', valid, torch.bool, 2)
    b, n = scores.shape
    if boxes.shape != (b, n, 6) or classes.shape != (b, n) or \
            valid.shape != (b, n):
        raise ValueError(
            f'boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}, '
            f'classes {tuple(classes.shape)} and valid {tuple(valid.shape)} '
            f'do not go together')
    if nms_shared_bytes(n) > SMEM_PER_BLOCK:
        raise ValueError(
            f'{n} boxes a scene need {nms_shared_bytes(n)} bytes of shared '
            f'memory, a block has {SMEM_PER_BLOCK}')
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b and n:
        NMS3D_KERNEL(boxes.data_ptr(), scores.data_ptr(), classes.data_ptr(),
                     valid.data_ptr(), keep.data_ptr(), b, n, float(thresh))
    return keep


def aligned_3d_nms_bitmask(boxes, scores, classes, thresh, valid):
    """K8's rule in plain Python, for the tests: a box's place in the order
    is the count of boxes before it (a larger key, NaN last and -0 with +0,
    or an equal key and a smaller index); for each place the later boxes of
    its class that it would suppress, as one integer of bits; and one
    greedy sweep over the order."""
    iou = pairwise_aligned_iou(boxes, classes)
    finite = torch.isfinite(boxes).all(-1)
    keys = torch.where(valid, scores, torch.full_like(scores, float('-inf')))
    keep = torch.zeros_like(valid)
    for s in range(scores.shape[0]):
        # NaN below -inf
        key = [(k == k, k if k == k else 0.0) for k in keys[s].tolist()]
        n = len(key)
        order = [0] * n
        for i in range(n):
            order[sum(key[j] > key[i] or (key[j] == key[i] and j < i)
                      for j in range(n))] = i
        above = (iou[s] > thresh) & finite[s][:, None] & finite[s][None, :]
        above = above[order][:, order].tolist()
        rows = [sum(1 << c for c in range(r + 1, n) if above[r][c])
                for r in range(n)]
        removed = sum(1 << r for r in range(n) if not valid[s, order[r]])
        for r in range(n):
            if not (removed >> r) & 1:
                keep[s, order[r]] = True
                removed |= rows[r]
    return keep
