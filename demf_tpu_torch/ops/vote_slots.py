"""The vote targets' in-box slots: CUDA kernel K18 and its plain version.

For each point of each scene, the GT boxes that hold it (``core/boxes.py::
points_in_boxes``, valid boxes only) as the indices the vote targets read:
the first hit, the k-th for 1 <= k < S - 1 and the last with at least
S - 1 earlier hits, for S = ``gt_per_seed`` slots, and whether each slot
has a hit.  Port of the slot expressions of ``demf_tpu/models/
target_assign.py::_vote_targets_single`` (the cumsum of earlier hits and
an argmax a slot); ``models/target_assign.py::_vote_targets`` reads the
centers at these slots.

A CPU tensor takes the plain version, the JAX package's expressions in
torch; a CUDA tensor launches K18 (``csrc/vote_slots.cu``: torch's cosine
and sine of the yaw, then one kernel, a thread a point walking the boxes in
order), which gives the same slots: it tests a pair with the roundings of
``points_in_boxes`` (``ops/box_count.py::box_terms``).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.boxes import points_in_boxes
from ._cuda import CudaKernel

VOTE_SLOTS_KERNEL = CudaKernel(
    'demf_vote_slots', [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 3 + [ctypes.c_float])
# csrc/vote_slots.cu: the most boxes a scene (their terms in a block's
# shared memory), slots a point and scenes (the grid's second axis)
MAX_BOXES = 1024
MAX_SLOTS = 8
MAX_SCENES = 65535


def vote_slots(points, boxes, valid, gt_per_seed, eps=1e-6):
    """points (B, P, >=3), boxes (B, G, 7) bottom-center, valid (B, G) bool
    -> (slots (B, P, S) int, has (B, P, S) bool): slot 0 the first box that
    holds the point (0 when none), slot k < S - 1 the box with k earlier
    hits (0 when none), slot S - 1 the last box with >= S - 1 earlier hits
    (G - 1 when none); has[k] where the point has more than k hits.  A CPU
    tensor takes the plain version (int64 slots), a CUDA tensor launches
    K18 (int32 slots) or raises."""
    if points.device.type == 'cpu':
        return vote_slots_plain(points, boxes, valid, gt_per_seed, eps)
    return vote_slots_cuda(points, boxes, valid, gt_per_seed, eps)


def vote_slots_plain(points, boxes, valid, gt_per_seed, eps=1e-6):
    """The slots as the JAX package's expressions give them: a (B, P, G)
    mask of ``points_in_boxes`` & valid, its cumsum of earlier hits, an
    argmax a slot."""
    in_box = points_in_boxes(points[..., :3], boxes, eps) & valid[:, None, :]
    hits = in_box.long()
    g = in_box.shape[-1]
    cnt_excl = hits.cumsum(-1) - hits                       # earlier hits
    slots, has = [hits.argmax(-1)], [in_box.any(-1)]
    for k in range(1, gt_per_seed):
        if k < gt_per_seed - 1:
            mk = in_box & (cnt_excl == k)
            slots.append(mk.long().argmax(-1))
        else:
            # last slot: the LAST box with >= k earlier hits (overwrite rule)
            mk = in_box & (cnt_excl >= k)
            slots.append((g - 1) - mk.flip(-1).long().argmax(-1))
        has.append(mk.any(-1))
    return torch.stack(slots, -1), torch.stack(has, -1)


def vote_slots_cuda(points, boxes, valid, gt_per_seed, eps=1e-6):
    """Kernel K18 (csrc/vote_slots.cu): float32 points (B, P, >=3) of any
    strides, float32 boxes (B, G, 7) and bool valid (B, G) on the same card.
    Three launches: the yaw's cosine and sine, the kernel.  Raises on other
    dtypes or shapes and beyond the kernel's limits (G 1 to 1,024 boxes,
    S 1 to 8 slots, B up to 65,535 scenes)."""
    for name, t, dtype in (('points', points, torch.float32),
                           ('boxes', boxes, torch.float32),
                           ('valid', valid, torch.bool)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
        if t.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    b, p = points.shape[:2]
    g = boxes.shape[1]
    if points.dim() != 3 or points.shape[2] < 3 or \
            boxes.shape != (b, g, 7) or valid.shape != (b, g) or \
            boxes.device != points.device or valid.device != points.device:
        raise ValueError(f'points {tuple(points.shape)}, boxes '
                         f'{tuple(boxes.shape)} and valid '
                         f'{tuple(valid.shape)} do not go together')
    if not (1 <= g <= MAX_BOXES and 1 <= gt_per_seed <= MAX_SLOTS and
            b <= MAX_SCENES):
        raise ValueError(f'{b} scenes of {g} boxes and {gt_per_seed} slots '
                         f'exceed the limits of K18')
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    yaw = boxes[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    slots = torch.empty((b, p, gt_per_seed), dtype=torch.int32,
                        device=points.device)
    has = torch.empty((b, p, gt_per_seed), dtype=torch.bool,
                      device=points.device)
    VOTE_SLOTS_KERNEL(points.data_ptr(), boxes.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), valid.data_ptr(), slots.data_ptr(),
                      has.data_ptr(), b, p, g, gt_per_seed, *points.stride(),
                      ctypes.c_float(eps))
    return slots, has
