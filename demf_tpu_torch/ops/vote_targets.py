"""The vote heads' vote targets: CUDA kernel K18 and its plain version.

For each point of each scene, the offsets to the gravity centers of the GT
boxes that hold it (``core/boxes.py::points_in_boxes``, valid boxes only):
the first hit, the k-th for 1 <= k < S - 1 and the last with at least
S - 1 earlier hits, for S = ``gt_per_seed`` slots, the first vote in a slot
without a hit, every slot times whether the point has a hit; and that
flag as the mask.  Port of ``demf_tpu/models/target_assign.py::
_vote_targets_single``; ``models/target_assign.py::_vote_targets`` calls
``vote_targets``.

A CPU tensor takes the plain version, the JAX package's expressions in
torch; a CUDA tensor launches K18 (``csrc/vote_targets.cu``: one kernel,
the yaw's cosine and sine in it, a block's valid boxes compacted into
shared memory, a thread 4 points walking them in order), which gives the
same bits: it tests a pair with the roundings of ``points_in_boxes``
(``ops/box_count.py::box_terms``) and forms each target with the chain's
roundings.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.boxes import gravity_center, points_in_boxes
from ._cuda import CudaKernel

VOTE_TARGETS_KERNEL = CudaKernel(
    'demf_vote_targets', [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 +
    [ctypes.c_longlong] * 3 + [ctypes.c_float])
# csrc/vote_targets.cu: the most boxes a scene (their terms in a block's
# shared memory), slots a point and scenes (the grid's second axis)
MAX_BOXES = 1024
MAX_SLOTS = 8
MAX_SCENES = 65535


def vote_targets(points, boxes, valid, gt_per_seed, eps=1e-6):
    """points (B, P, >=3), boxes (B, G, 7) bottom-center, valid (B, G) bool
    -> (vote_targets (B, P, 3 * S) in the points' dtype, vote_target_masks
    (B, P) int32): slot 0 the first box that holds the point, slot
    k < S - 1 the box with k earlier hits, slot S - 1 the last box with
    >= S - 1 earlier hits, each its gravity center - the point, the first
    vote (box 0's center - the point when there is no hit) in a slot
    without a hit, all times whether the point has a hit.  A CPU tensor
    takes the plain version, a CUDA tensor launches K18 or raises."""
    if points.device.type == 'cpu':
        return vote_targets_plain(points, boxes, valid, gt_per_seed, eps)
    return vote_targets_cuda(points, boxes, valid, gt_per_seed, eps)


def vote_targets_plain(points, boxes, valid, gt_per_seed, eps=1e-6):
    """The vote targets and masks as the JAX package's expressions give
    them: a (B, P, G) mask of ``points_in_boxes`` & valid, its cumsum of
    earlier hits, an argmax a slot, the centers taken at the slots, the
    first vote where a slot has no hit, times has1."""
    points = points[..., :3]
    in_box = points_in_boxes(points, boxes, eps) & valid[:, None, :]
    hits = in_box.long()
    b, p, g = in_box.shape
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
    slots, has = torch.stack(slots, -1), torch.stack(has, -1)
    centers = gravity_center(boxes)                         # (B, G, 3)
    index = slots.reshape(b, p * gt_per_seed, 1).expand(-1, -1, 3)
    votes = torch.gather(centers, 1, index).view(
        b, p, gt_per_seed, 3) - points[:, :, None]
    votes = torch.where(has[..., None], votes, votes[:, :, :1])
    return (votes.reshape(b, p, 3 * gt_per_seed) * has[..., :1],
            has[..., 0].int())


def vote_targets_cuda(points, boxes, valid, gt_per_seed, eps=1e-6):
    """Kernel K18 (csrc/vote_targets.cu), one launch: float32 points (B, P,
    >=3) of any strides, float32 boxes (B, G, 7) and bool valid (B, G) on
    the same card.  Raises on other dtypes or shapes and beyond the
    kernel's limits (G 1 to 1,024 boxes, S 1 to 8 slots, B up to 65,535
    scenes)."""
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
    targets = torch.empty((b, p, 3 * gt_per_seed), dtype=torch.float32,
                          device=points.device)
    masks = torch.empty((b, p), dtype=torch.int32, device=points.device)
    VOTE_TARGETS_KERNEL(points.data_ptr(), boxes.data_ptr(),
                        valid.data_ptr(), targets.data_ptr(),
                        masks.data_ptr(), b, p, g, gt_per_seed,
                        *points.stride(), ctypes.c_float(eps))
    return targets, masks
