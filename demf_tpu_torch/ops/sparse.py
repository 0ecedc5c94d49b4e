"""Sparse 3D convolution on fixed-capacity voxel tables: the kernel map
(CUDA kernel K13), the gather-GEMM convolution (CUDA kernel K14) and their
plain versions, with the voxelization, stride and pooling around them.

Port of ``demf_tpu/ops/sparse.py``, forward only, under the JAX package's
names.  A scene's voxels live in a table of static capacity M: ``coords``
(B, M, 3) int32 voxel indices (``INVALID`` on padding rows), ``valid``
(B, M) and features (B, M, C).  Every table the FCAF3D family makes is in
sorted-key, valid-prefix order (``voxelize`` and ``downsample_coords``
write rows in the order of ``linearize``'s keys, padding last), which is
what ``sorted_input=True`` asserts, so that a table's keys are its rows'
keys as they stand (``key_table_presorted``).

* ``neighbor_table_batched``: for each query row and tap t, the input row
  whose coordinate is ``query + offsets[t] * in_stride``, or -1.  A CUDA
  tensor launches K13 (``csrc/kernel_map.cu``: a thread a (query, tap), a
  binary search in the scene's sorted keys); a CPU tensor takes
  ``torch.searchsorted``.  The JAX package's bucketed and z-run lookups
  exist only to suit the TPU and are not ported: both give the exact match
  of the coordinate, which is what the search gives.
* ``sparse_conv_apply_batched``: ``out[b, m] = sum_t feats[b, nbr[b, m,
  t]] @ W[t]``, absent taps adding 0.  A CUDA tensor launches K14
  (``csrc/sparse_conv.cu``, float32 or bfloat16 rows and weights, float32
  sums); a CPU tensor takes the plain per-tap gather and matmul.  The
  forward only: the backward (the reverse tables of ``_conv_sym`` /
  ``_conv_revgeo``) comes with the training slice, so on the card a
  feature or weight that takes a gradient is refused.

Tap order.  ``kernel_offsets(k)`` enumerates taps with the last axis
fastest, as the JAX package does; ``kernel_offsets(k, me_order=True)``
with the first axis fastest, MinkowskiEngine's order, in which mmdet3d
stores a sparse kernel (K^3, C_in, C_out).  The port's convolutions take
their kernels in MinkowskiEngine's order, so that a released mmdet3d
FCAF3D file loads as it is; ``engine/weights.py::state_dict_from_jax``
permutes the JAX package's taps once, at conversion (``me_tap_order``).
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda

_SPAN = 1290                       # per-axis key span; _SPAN**3 < 2**31
_SHIFT = 16                        # headroom for negative tap queries
INVALID = _SPAN - _SHIFT - 1       # sentinel coordinate (=1273)
MAX_COORD = _SPAN - _SHIFT - 2     # largest real coordinate
KEY_PAD = 2 ** 31 - 1              # the key of a padding row

# K13: sorted keys, their rows (or null: the rows are the positions), query
# coords, query valid, offsets, out; B, M_in, Q, K, stride
KERNEL_MAP_KERNEL = CudaKernel(
    'demf_kernel_map', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5)
# K14: feats, nbr, weights, out; B, M_in, C, M_out, K, C_out (an entry a
# dtype)
SPARSE_CONV_KERNEL = CudaKernel(
    'demf_sparse_conv', [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6)
SPARSE_CONV_BF16_KERNEL = CudaKernel(
    'demf_sparse_conv_bf16', SPARSE_CONV_KERNEL.argtypes)


def linearize(coords):
    """(..., 3) int coords in [-16, 1273] -> unique int32 keys, the last
    axis fastest."""
    c = coords.to(torch.int32) + _SHIFT
    return (c[..., 0] * _SPAN + c[..., 1]) * _SPAN + c[..., 2]


def _segments(skeys, capacity):
    """Sorted keys (B, N) -> each element's segment id (one a distinct key,
    in order), with ids past ``capacity`` sent to ``capacity``."""
    heads = torch.ones_like(skeys, dtype=torch.bool)
    heads[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    seg = torch.cumsum(heads, 1) - 1
    return seg.clamp(max=capacity)


def _first_of_segments(seg, capacity):
    """(B, capacity) the first position of each segment id (``n`` where a
    segment is empty); ids equal to ``capacity`` are dropped, as the JAX
    package's out-of-bounds ``.at[seg].min`` drops them."""
    b, n = seg.shape
    flat = (seg + torch.arange(b, device=seg.device)[:, None] *
            (capacity + 1)).reshape(-1)
    pos = torch.arange(n, device=seg.device).repeat(b)
    first = torch.full((b * (capacity + 1),), n, dtype=torch.long,
                       device=seg.device)
    first.scatter_reduce_(0, flat, pos, 'amin')
    return first.reshape(b, capacity + 1)[:, :capacity], flat


def voxelize(points, features, voxel_size, pc_start, max_voxels):
    """Points -> mean-pooled voxel tables of capacity ``max_voxels``.

    points (B, N, 3), features (B, N, C).  A point outside ``[0,
    MAX_COORD]`` voxels on any axis is dropped; past the capacity only the
    first ``max_voxels`` voxels in key order are kept.  The coordinate is
    ``floor((p - pc_start) / voxel_size)`` in float32, divided by a tensor
    as the JAX package divides (a division by a Python number is a product
    with its reciprocal in PyTorch, and differs at cell borders).
    Returns coords (B, M, 3) int32 (``INVALID`` padded), feats (B, M, C)
    in the features' dtype and valid (B, M), in sorted-key, valid-prefix
    order.
    """
    b, n, _ = points.shape
    c = features.shape[-1]
    m = max_voxels
    dev = points.device
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
    start = torch.as_tensor(pc_start, dtype=torch.float32, device=dev)
    raw = torch.floor((points.float() - start) / vs)
    in_range = ((raw >= 0) & (raw <= MAX_COORD)).all(-1)
    coords = raw.clamp(0, MAX_COORD).to(torch.int32)
    keys = torch.where(in_range, linearize(coords), KEY_PAD)
    order = torch.argsort(keys, dim=1, stable=True)
    skeys = keys.gather(1, order)
    sfeat = features.gather(1, order[..., None].expand(-1, -1, c))
    scoord = coords.gather(1, order[..., None].expand(-1, -1, 3))
    seg = torch.where(in_range.gather(1, order), _segments(skeys, m), m)
    first, flat = _first_of_segments(seg, m)
    feat_sum = torch.zeros((b * (m + 1), c), dtype=features.dtype,
                           device=dev)
    feat_sum.index_add_(0, flat, sfeat.reshape(-1, c))
    cnt = torch.zeros(b * (m + 1), dtype=torch.float32, device=dev)
    cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    feat_sum = feat_sum.reshape(b, m + 1, c)[:, :m]
    cnt = cnt.reshape(b, m + 1)[:, :m]
    valid = cnt > 0
    rows = scoord.gather(1, first.clamp(max=n - 1)[..., None].expand(
        -1, -1, 3))
    coords_out = torch.where(valid[..., None], rows, INVALID)
    feats_out = feat_sum / torch.clamp(cnt[..., None], min=1.0)
    return coords_out, feats_out.to(features.dtype), valid


def build_key_table(coords, valid):
    """Sorted key tables for neighbor lookups: (skeys, row_of_rank), each
    (B, M)."""
    keys = torch.where(valid, linearize(coords), KEY_PAD)
    order = torch.argsort(keys, dim=-1, stable=True)
    return keys.gather(-1, order), order.to(torch.int32)


def key_table_presorted(coords, valid):
    """``build_key_table`` for tables already in key order: the keys as
    they stand, and no row map (a row is its position)."""
    return torch.where(valid, linearize(coords), KEY_PAD), None


def kernel_offsets(kernel_size, me_order=False, device=None):
    """(K, 3) int32 offsets of a cubic kernel: centered for an odd size,
    forward (taps at 0..k-1, Minkowski's convention) for an even one.  The
    last axis is fastest; with ``me_order`` the first (MinkowskiEngine's
    tap order)."""
    k = kernel_size
    r = torch.arange(k, device=device)
    if k % 2 == 1:
        r = r - (k - 1) // 2
    slow, mid, fast = (a.reshape(-1) for a in
                       torch.meshgrid(r, r, r, indexing='ij'))
    axes = (fast, mid, slow) if me_order else (slow, mid, fast)
    return torch.stack(axes, -1).to(torch.int32)


def neighbor_table_batched(in_coords, in_valid, out_coords, out_valid,
                           offsets, in_stride=1, sorted_input=False):
    """(B, M_out, K) int32 rows of the input table (-1 = no neighbor): tap
    t of output row q reads the input row at ``out_coords[q] + offsets[t]
    * in_stride``; an invalid output row has none.  ``sorted_input``
    asserts that ``in_coords`` is in sorted-key, valid-prefix order.  A
    CUDA tensor launches K13; a CPU tensor takes the plain search."""
    table_fn = key_table_presorted if sorted_input else build_key_table
    skeys, order = table_fn(in_coords, in_valid)
    offsets = offsets.to(device=out_coords.device, dtype=torch.int32)
    if out_coords.device.type == 'cpu':
        return kernel_map_plain(skeys, order, out_coords, out_valid,
                                offsets, in_stride)
    return kernel_map_cuda(skeys, order, out_coords.to(torch.int32),
                           out_valid, offsets, in_stride)


def kernel_map_plain(skeys, order, query_coords, query_valid, offsets,
                     stride):
    """K13's function: each query + tap's coordinate searched among the
    sorted keys (B, M) (``order`` maps a rank to its row, None when the
    rank is the row); a coordinate off ``[0, MAX_COORD]`` on any axis, or
    an invalid query, finds nothing."""
    b, q, _ = query_coords.shape
    k = offsets.shape[0]
    c = query_coords.to(torch.int32)[:, :, None, :] + offsets * stride
    inside = ((c >= 0) & (c <= MAX_COORD)).all(-1) & query_valid[..., None]
    keys = linearize(c.clamp(0, MAX_COORD)).reshape(b, q * k)
    pos = torch.searchsorted(skeys.contiguous(), keys.contiguous())
    pos = pos.clamp(max=skeys.shape[1] - 1)
    hit = (skeys.gather(1, pos) == keys).reshape(b, q, k) & inside
    rows = pos if order is None else order.gather(1, pos).long()
    return torch.where(hit, rows.reshape(b, q, k), -1).to(torch.int32)


def kernel_map_cuda(skeys, order, query_coords, query_valid, offsets,
                    stride):
    """Kernel K13 (csrc/kernel_map.cu): int32 sorted keys (B, M) and, when
    the table is not presorted, their rows; int32 query coords (B, Q, 3),
    bool valid (B, Q) and int32 offsets (K, 3), all contiguous on the
    card."""
    check_cuda('skeys', skeys, torch.int32, 2)
    if order is not None:
        check_cuda('order', order, torch.int32, 2)
    check_cuda('query_coords', query_coords, torch.int32, 3)
    check_cuda('query_valid', query_valid, torch.bool, 2)
    check_cuda('offsets', offsets, torch.int32, 2)
    b, m = skeys.shape
    q = query_coords.shape[1]
    k = offsets.shape[0]
    if query_coords.shape != (b, q, 3) or query_valid.shape != (b, q) or \
            offsets.shape != (k, 3) or (order is not None and
                                        order.shape != (b, m)):
        raise ValueError(
            f'keys {tuple(skeys.shape)}, queries '
            f'{tuple(query_coords.shape)}, valid {tuple(query_valid.shape)} '
            f'and offsets {tuple(offsets.shape)} do not go together')
    out = torch.empty((b, q, k), dtype=torch.int32, device=skeys.device)
    if out.numel():
        KERNEL_MAP_KERNEL(skeys.data_ptr(),
                          0 if order is None else order.data_ptr(),
                          query_coords.data_ptr(), query_valid.data_ptr(),
                          offsets.data_ptr(), out.data_ptr(), b, m, q, k,
                          int(stride))
    return out


def sparse_conv_apply_batched(feats, nbr, weights):
    """Gather-GEMM sparse convolution: feats (B, M, C), nbr (B, M_out, K),
    weights (K, C, C_out) -> (B, M_out, C_out) in the features' dtype (the
    weights go to it, as the JAX package casts them to the rows').  A CUDA
    tensor launches K14, a CPU tensor takes the plain version."""
    weights = weights.to(feats.dtype)
    if feats.device.type == 'cpu':
        return sparse_conv_plain(feats, nbr, weights)
    if torch.is_grad_enabled() and (feats.requires_grad or
                                    weights.requires_grad):
        raise NotImplementedError(
            'the sparse convolution\'s backward is not ported yet '
            '(ROADMAP M8, the training half): K14 is forward only')
    return sparse_conv_cuda(feats.contiguous(), nbr.contiguous(),
                            weights.contiguous())


def sparse_conv_plain(feats, nbr, weights):
    """K14's function, a tap at a time: the rows gathered (absent ones 0)
    times the tap's kernel, summed in float32 in tap order and returned in
    the features' dtype (a float32 product of bfloat16 operands is exact,
    so a bfloat16 call rounds once, at the end)."""
    b, m, c = feats.shape
    mo, k = nbr.shape[1:]
    flat = feats.reshape(b * m, c)
    base = (torch.arange(b, device=feats.device) * m)[:, None]
    acc = torch.zeros((b, mo, weights.shape[2]), dtype=torch.float32,
                      device=feats.device)
    for t in range(k):
        idx = nbr[..., t].long()
        g = flat[(idx.clamp(min=0) + base).reshape(-1)].reshape(b, mo, c)
        g = torch.where((idx >= 0)[..., None], g, 0).float()
        acc = acc + g @ weights[t].float()
    return acc.to(feats.dtype)


def sparse_conv_cuda(feats, nbr, weights):
    """Kernel K14 (csrc/sparse_conv.cu): float32 or bfloat16 feats (B, M,
    C) and weights (K, C, C_out) of one dtype, int32 nbr (B, M_out, K), all
    contiguous on the card -> (B, M_out, C_out) in their dtype."""
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'feats must be float32 or bfloat16, got '
                        f'{feats.dtype}')
    check_cuda('feats', feats, feats.dtype, 3)
    check_cuda('nbr', nbr, torch.int32, 3)
    check_cuda('weights', weights, feats.dtype, 3)
    b, m, c = feats.shape
    mo, k = nbr.shape[1:]
    co = weights.shape[2]
    if nbr.shape[0] != b or weights.shape[:2] != (k, c):
        raise ValueError(
            f'feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)} and '
            f'weights {tuple(weights.shape)} do not go together')
    out = torch.empty((b, mo, co), dtype=feats.dtype, device=feats.device)
    if out.numel():
        kernel = (SPARSE_CONV_BF16_KERNEL if feats.dtype == torch.bfloat16
                  else SPARSE_CONV_KERNEL)
        kernel(feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
               out.data_ptr(), b, m, c, mo, k, co)
    return out


def submanifold_conv_batched(coords, valid, feats, weights, kernel_size=3,
                             tensor_stride=1, nbr=None, sorted_input=False):
    """MinkowskiConvolution(stride=1) on the same coordinate set; ``nbr``
    may be the level's table (taps in MinkowskiEngine's order), built once
    and shared by its convs."""
    if nbr is None:
        offs = kernel_offsets(kernel_size, True, coords.device)
        nbr = neighbor_table_batched(coords, valid, coords, valid, offs,
                                     in_stride=tensor_stride,
                                     sorted_input=sorted_input)
    out = sparse_conv_apply_batched(feats, nbr, weights)
    return torch.where(valid[..., None], out, 0)


def downsample_coords(coords, valid, stride, max_out):
    """Unique ``coords // stride * stride`` of each scene (the coarse set
    in fine units), capacity ``max_out``, in sorted-key, valid-prefix
    order: Minkowski's stride-s output coordinates.  (B, M, 3) ->
    (coords (B, max_out, 3), valid (B, max_out))."""
    b, n, _ = coords.shape
    coarse = torch.where(valid[..., None],
                         torch.div(coords, stride, rounding_mode='floor') *
                         stride, INVALID).to(torch.int32)
    keys = linearize(coarse)
    order = torch.argsort(keys, dim=1, stable=True)
    sc = coarse.gather(1, order[..., None].expand(-1, -1, 3))
    first, _ = _first_of_segments(_segments(keys.gather(1, order), max_out),
                                  max_out)
    safe = first.clamp(max=n - 1)
    out_valid = (first < n) & valid.gather(1, order).gather(1, safe)
    out_coords = torch.where(out_valid[..., None],
                             sc.gather(1, safe[..., None].expand(-1, -1, 3)),
                             INVALID)
    return out_coords, out_valid


def strided_conv_batched(coords, valid, feats, weights, stride=2,
                         kernel_size=2, max_out=None, tensor_stride=1,
                         sorted_input=False):
    """MinkowskiConvolution(kernel=k, stride=s): ``tensor_stride`` is the
    input level's granularity, the output's is ``tensor_stride * stride``
    (coords stay in finest units).  Returns (out_coords, out_valid,
    out_feats)."""
    max_out = max_out or coords.shape[1]
    offs = kernel_offsets(kernel_size, True, coords.device)
    oc, ov = downsample_coords(coords, valid, stride * tensor_stride,
                               max_out)
    nbr = neighbor_table_batched(coords, valid, oc, ov, offs,
                                 in_stride=tensor_stride,
                                 sorted_input=sorted_input)
    out = sparse_conv_apply_batched(feats, nbr, weights)
    return oc, ov, torch.where(ov[..., None], out, 0)


def sparse_max_pool_batched(coords, valid, feats, stride=2, kernel_size=2,
                            max_out=None, tensor_stride=1,
                            sorted_input=False):
    """MinkowskiMaxPooling(kernel=k, stride=s): the max over each output
    voxel's taps (0 where it has none)."""
    max_out = max_out or coords.shape[1]
    offs = kernel_offsets(kernel_size, device=coords.device)
    oc, ov = downsample_coords(coords, valid, stride * tensor_stride,
                               max_out)
    nbr = neighbor_table_batched(coords, valid, oc, ov, offs,
                                 in_stride=tensor_stride,
                                 sorted_input=sorted_input)
    b, m, c = feats.shape
    flat = feats.reshape(b * m, c)
    base = (torch.arange(b, device=feats.device) * m)[:, None]
    out = torch.full((b, nbr.shape[1], c), float('-inf'), dtype=feats.dtype,
                     device=feats.device)
    for t in range(nbr.shape[2]):
        idx = nbr[..., t].long()
        g = flat[(idx.clamp(min=0) + base).reshape(-1)].reshape(
            b, -1, c)
        out = torch.maximum(out, torch.where((idx >= 0)[..., None], g,
                                             float('-inf')))
    out = torch.where(torch.isfinite(out), out, 0)
    return oc, ov, torch.where(ov[..., None], out, 0)


def transposed_conv_to_batched(coords_fine, valid_fine, coords_coarse,
                               valid_coarse, feats_coarse, weights, stride=2,
                               kernel_size=2, tensor_stride=1,
                               sorted_input=False):
    """MinkowskiConvolutionTranspose(kernel=2, stride=2) onto a known fine
    coordinate set (the encoder skip's table), as FCAF3D's decoder
    upsamples: each fine voxel's parent ``coords_fine // cs * cs`` is found
    with a one-tap K13 lookup, its tap is the offset ``(fine - parent) //
    tensor_stride``, and the (B, M_f, K) table holding the parent at that
    tap goes through K14.  ``tensor_stride`` is the fine level's
    granularity."""
    cs = stride * tensor_stride
    parent = torch.div(coords_fine, cs, rounding_mode='floor') * cs
    zero = torch.zeros((1, 3), dtype=torch.int32, device=coords_fine.device)
    prow = neighbor_table_batched(coords_coarse, valid_coarse, parent,
                                  valid_fine, zero,
                                  sorted_input=sorted_input)[..., 0]
    off = torch.div(coords_fine - parent, tensor_stride,
                    rounding_mode='floor')
    k = kernel_size
    tap = off[..., 0] + k * (off[..., 1] + k * off[..., 2])  # the first
    taps = torch.arange(k ** 3, device=tap.device)          # axis fastest
    tnbr = torch.where((tap[..., None] == taps) & (prow[..., None] >= 0),
                       prow[..., None], -1).to(torch.int32)
    out = sparse_conv_apply_batched(feats_coarse, tnbr, weights)
    return torch.where(valid_fine[..., None], out, 0)


def global_max_pool(feats, valid):
    """(M, C) -> (C,) the max over the valid rows."""
    return torch.where(valid[:, None], feats, float('-inf')).max(0).values
