"""Greedy 2D NMS, batched over B and separated by group: CUDA kernel K10
and its plain version.

Port of ``demf_tpu/ops/nms.py``'s 2D functions (``nms_2d``,
``batched_nms_2d``, with ``_greedy_suppress`` for N <= 4096 and
``_greedy_suppress_rowwise_2d`` above; both have one semantics):

* greedy, in the order of ``argsort(-where(valid, score, -inf))``, which is
  stable, so equal scores go to the lower index;
* a kept box suppresses a later one where ``iou > thresh``, with
  ``iou = inter / max(area_i + area_j - inter, 1e-8)``;
* boxes of another group (``idxs``) never suppress each other;
* invalid entries are never kept, so they suppress nothing either.

A CUDA tensor launches K10 (``csrc/nms2d.cu``); a CPU tensor takes the plain
version, a Python loop over the order that computes one pivot's IoU row a
step (the JAX package's row-wise form: no (N, N) matrix at the R-CNN's
10,000 candidates).

K10 sorts by (group, -score, index) instead of by (-score, index): groups
never interact, so each group's greedy sweep over its own part of the
global order keeps the same boxes.  It builds that order on the card from
one packed key a candidate (``k10_keys``: the group's low 16 bits, or an
invalid flag above them; the score's order bits; the index), so every key
is unique and any sort is the stable one.  Ids that share their low 16 bits
share a place in the order and are told apart when the suppression bits
are made, so any int64 id is taken, with no check on the host.
``k10_order`` is the same order from two stable sorts (the form of the
first version, for the tests), and ``batched_nms_2d_tiled`` is K10's rule
written out in Python (suppression bits in 64-bit words of 64x64 tiles,
restricted to a row's own id, then a sweep of each group a word at a time:
the diagonal tile serially, then the kept rows' later words OR-ed in), so
that the rule is tested where the kernel cannot run.

What a NaN does, on every path: a pair whose IoU is NaN suppresses nothing
(``NaN > thresh`` is false), and a box with a coordinate that is not finite
has an IoU of 0 or NaN with every box, so it neither suppresses nor is
suppressed; a NaN score comes last in its group.  ``thresh`` must be >= 0.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda

NMS2D_KERNEL = CudaKernel(
    'demf_nms2d', [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 +
    [ctypes.c_float])

# the most candidates K10 takes an image: the 14 index bits of its key, the
# 136 KB of its sort in shared memory
K10_MAX_N = 16384
# the group of an invalid entry in ``k10_order``: after every real group
INVALID_GROUP = torch.iinfo(torch.int64).max
# K10's key: (code << 46) | (score's order bits << 14) | index, where code
# is the id's low 16 bits, or INVALID_CODE for an invalid entry
INDEX_BITS = 14
GROUP_SHIFT = INDEX_BITS + 32
INVALID_CODE = 1 << 16


def batched_nms_2d(boxes, scores, idxs, thresh, valid=None):
    """Category-separated 2D NMS.

    boxes (B, N, 4) xyxy, scores (B, N), idxs (B, N) integer groups, valid
    (B, N) bool or None -> (B, N) bool keep mask in the original order.  A
    CPU tensor takes the plain version; a CUDA tensor launches K10 (on
    contiguous copies where an input is a view) or raises.  Bfloat16 scores
    (the RPN's under the bf16 policy) are widened to float32 first: the
    cast is exact, so the order and its ties are those of the bf16 values.
    """
    if not thresh >= 0:
        raise ValueError(f'thresh must be >= 0, got {thresh}')
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    if scores.dtype == torch.bfloat16:
        scores = scores.float()
    if boxes.device.type == 'cpu':
        return batched_nms_2d_plain(boxes, scores, idxs, thresh, valid)
    return batched_nms_2d_cuda(boxes.contiguous(), scores.contiguous(),
                               idxs.contiguous(), thresh, valid.contiguous())


def nms_2d(boxes, scores, thresh, valid=None):
    """Classic 2D NMS over (B, N, 4) xyxy boxes: K10 with one group."""
    return batched_nms_2d(boxes, scores, torch.zeros_like(
        scores, dtype=torch.int64), thresh, valid)


def box_areas(boxes):
    """(..., 4) xyxy -> (...) ``max(x2 - x1, 0) * max(y2 - y1, 0)``."""
    e = (boxes[..., 2:] - boxes[..., :2]).clamp_min(0)
    return e[..., 0] * e[..., 1]


def iou_2d(a, b, area_a, area_b):
    """IoU of boxes ``a`` and ``b`` (broadcast over their leading axes),
    with the JAX package's roundings: ``(dx * dy)`` over
    ``max((area_a + area_b) - inter, 1e-8)``; K10 repeats them."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    d = (rb - lt).clamp_min(0)
    inter = d[..., 0] * d[..., 1]
    return inter / (area_a + area_b - inter).clamp_min(1e-8)


def batched_nms_2d_plain(boxes, scores, idxs, thresh, valid):
    """The greedy sweep in the global order as a loop, one pivot's IoU row
    (against the later boxes) a step; it stops after the last entry that
    could be kept."""
    b, n = scores.shape
    neg_inf = torch.full_like(scores, float('-inf'))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ids = torch.gather(idxs, 1, order)
    keep = torch.gather(valid, 1, order)
    area = box_areas(bx)
    alive = keep.any(0).nonzero()
    last = int(alive.max()) + 1 if len(alive) else 0
    for i in range(last):
        iou = iou_2d(bx[:, i:i + 1], bx[:, i + 1:], area[:, i:i + 1],
                     area[:, i + 1:])
        sup = (iou > thresh) & (ids[:, i + 1:] == ids[:, i:i + 1])
        keep[:, i + 1:] &= ~(sup & keep[:, i:i + 1])
    return torch.zeros_like(keep).scatter(1, order, keep)


def k10_order(scores, idxs, valid):
    """K10's order: by group, then as the global order ranks them (score
    descending with invalid entries as -inf, stable), invalid entries last
    in a group of their own.  -> (order (B, N) int64, the groups in that
    order (B, N) int64)."""
    neg_inf = torch.full_like(scores, float('-inf'))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    groups = torch.where(valid, idxs.long(),
                         torch.full_like(idxs, INVALID_GROUP, dtype=torch.long))
    groups = torch.gather(groups, 1, order)
    by_group = torch.argsort(groups, dim=-1, stable=True)
    return (torch.gather(order, 1, by_group),
            torch.gather(groups, 1, by_group))


def k10_keys(scores, idxs, valid):
    """K10's packed key of each candidate, as the kernel builds it:
    (B, N) int64, each >= 0 and unique in its image.  Ascending keys give
    the order by group code (an id's low 16 bits; invalid entries after
    every code), then score descending (-0 ties with +0, -inf before NaN,
    every NaN tied and last), then index."""
    n = scores.shape[-1]
    if n > K10_MAX_N:
        raise ValueError(f'{n} candidates an image: K10 takes at most '
                         f'{K10_MAX_N}')
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    u = s.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    ascending = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | 1 << 31)
    order_bits = torch.where(torch.isnan(scores),
                             torch.full_like(u, 0xFFFFFFFF),
                             ascending ^ 0xFFFFFFFF)
    code = torch.where(valid, idxs.long() & 0xFFFF,
                       torch.full_like(u, INVALID_CODE))
    index = torch.arange(n, device=scores.device)
    return (code << GROUP_SHIFT) | (order_bits << INDEX_BITS) | index


def k10_packed_order(scores, idxs, valid):
    """K10's order from its keys: -> (order (B, N) int64, the sorted keys
    (B, N) int64)."""
    keys = torch.sort(k10_keys(scores, idxs, valid), dim=-1).values
    return keys & (K10_MAX_N - 1), keys


def batched_nms_2d_cuda(boxes, scores, idxs, thresh, valid):
    """Kernel K10 (csrc/nms2d.cu): float32 boxes and scores, integer idxs
    (any int64 id), bool valid, all contiguous on the card.  Two launches:
    the order (one block an image sorts the packed keys in shared memory)
    and the suppression bits of 64x64 tiles into a (B, N, N / 64) scratch
    of 64-bit words with each group swept by the block that finishes its
    last tile.  Raises above ``K10_MAX_N`` candidates an image."""
    check_cuda('boxes', boxes, torch.float32, 3)
    check_cuda('scores', scores, torch.float32, 2)
    check_cuda('valid', valid, torch.bool, 2)
    if not idxs.is_cuda or idxs.dtype.is_floating_point or \
            idxs.dtype == torch.bool:
        raise TypeError(f'idxs must be an integer CUDA tensor, got '
                        f'{idxs.dtype} on {idxs.device}')
    b, n = scores.shape
    if boxes.shape != (b, n, 4) or idxs.shape != (b, n) or \
            valid.shape != (b, n):
        raise ValueError(
            f'boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}, '
            f'idxs {tuple(idxs.shape)} and valid {tuple(valid.shape)} do not '
            f'go together')
    if n > K10_MAX_N:
        raise ValueError(f'{n} candidates an image: K10 takes at most '
                         f'{K10_MAX_N}')
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    idxs = idxs.long().contiguous()
    # one scratch: sorted boxes (16 bytes), ids (8), spans (8), original
    # indices (4), done counters (4) a candidate, then the bits
    words = (n + 63) // 64
    m = b * n
    scratch = torch.empty(40 * m + 8 * m * words, dtype=torch.uint8,
                          device=boxes.device)
    base = scratch.data_ptr()
    NMS2D_KERNEL(boxes.data_ptr(), scores.data_ptr(), idxs.data_ptr(),
                 valid.data_ptr(), base, base + 16 * m, base + 32 * m,
                 base + 24 * m, base + 36 * m, base + 40 * m,
                 keep.data_ptr(), b, n, float(thresh))
    return keep


def batched_nms_2d_tiled(boxes, scores, idxs, thresh, valid):
    """K10's rule in plain Python, for the tests: the order of
    ``k10_packed_order``; for each place, as integers of 64 bits a word,
    the later places of its code group with its own id that it would
    suppress (a box whose coordinates are not all finite has none and is
    in none); then each code group swept a 64-place word at a time: the
    word's own places resolved in order against the removed bits, then the
    kept places' later words OR-ed into the removed bits."""
    order, keys = k10_packed_order(scores, idxs, valid)
    codes = keys >> GROUP_SHIFT
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ids = torch.gather(idxs.long(), 1, order)
    area = box_areas(bx)
    finite = torch.isfinite(bx).all(-1)
    keep = torch.zeros_like(valid)
    n = scores.shape[1]
    for s in range(scores.shape[0]):
        code, gid = codes[s].tolist(), ids[s].tolist()
        iou = iou_2d(bx[s, :, None], bx[s, None], area[s, :, None],
                     area[s, None])
        above = ((iou > thresh) & finite[s, :, None] &
                 finite[s, None, :]).tolist()
        start = 0
        while start < n:
            end = start
            while end < n and code[end] == code[start]:
                end += 1
            if code[start] != INVALID_CODE:
                for r in _swept_kept(above, gid, start, end):
                    keep[s, order[s, r]] = True
            start = end
    return keep


def _swept_kept(above, gid, start, end):
    """The kept places of one code group [start, end) (see
    ``batched_nms_2d_tiled``)."""
    w0, w1 = start // 64, (end - 1) // 64

    def word_bits(r, word):
        return sum(1 << (c % 64) for c in range(max(word * 64, r + 1),
                                                min(word * 64 + 64, end))
                   if above[r][c] and gid[c] == gid[r])

    removed = [0] * (w1 - w0 + 1)
    kept = []
    for word in range(w0, w1 + 1):
        rem = removed[word - w0]
        tile_kept = []
        for r in range(max(start, word * 64), min(end, word * 64 + 64)):
            if (rem >> (r % 64)) & 1:
                continue
            tile_kept.append(r)
            rem |= word_bits(r, word)
        for r in tile_kept:
            for later in range(word + 1, w1 + 1):
                removed[later - w0] |= word_bits(r, later)
        kept += tile_kept
    return kept
