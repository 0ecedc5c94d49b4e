"""Sparse 3D convolution on fixed-capacity voxel tables: the kernel map
(CUDA kernel K13), the gather-GEMM convolution (CUDA kernel K14), the max
pool (CUDA kernel K17) and their plain versions, with the voxelization and
stride around them.

Port of ``demf_tpu/ops/sparse.py``, forward only, under the JAX package's
names.  A scene's voxels live in a table of static capacity M: ``coords``
(B, M, 3) int32 voxel indices (``INVALID`` on padding rows), ``valid``
(B, M) and features (B, M, C).  Every table the FCAF3D family makes is in
sorted-key, valid-prefix order (``voxelize`` and ``downsample_coords``
write rows in the order of ``linearize``'s keys, padding last), which is
what ``sorted_input=True`` asserts, so that a table's keys are its rows'
keys as they stand (``key_table_presorted``).

* ``kernel_tables``: the tables a model knows together, one K13 launch on
  the card (``csrc/kernel_map.cu``: a job a table, passed by value; a
  block 64 query rows, the window of the sorted table that holds their
  targets searched in shared memory), each a ``TableJob``: for each query
  row and tap t, the row of the presorted key table whose coordinate is
  ``query + offset_t * stride`` (the offsets of a cubic kernel of
  ``kernel_size`` in either tap order), or -1; or with ``cell`` a
  transposed convolution's table (``transposed_table``).  The kernel
  linearizes the keys and makes the offsets itself, so no torch op runs
  around it; a CPU tensor takes ``kernel_table_plain`` (``torch.
  searchsorted``).  ``neighbor_table_batched`` takes explicit offsets and
  a table in any order (sorted first: ``build_key_table``), the tests'
  route.  The JAX package's bucketed and z-run lookups exist only to suit
  the TPU and are not ported: both give the exact match of the coordinate,
  which is what the search gives.
* ``sparse_conv_apply_batched``: ``out[b, m] = sum_t feats[b, nbr[b, m,
  t]] @ W[t]``, absent taps adding 0, as the autograd Function
  ``SparseConv``.  A CUDA tensor launches K14 (``csrc/sparse_conv.cu``,
  float32 or bfloat16 rows and weights, float32 sums) on the table's row
  plan (``conv_plan``: each row's tap mask, the rows sorted by it, each
  64-row tile's taps), which the model builds once a table and hands to
  every convolution that reads it (``plan=``); a CPU tensor takes the
  plain per-tap gather and matmul (``sparse_conv_tiles_plain`` walks the
  kernel's order instead).
* The backward, on the CPU too (the plain versions there): d_feats is K14
  again on the table's reverse table (``Reverse``: tap t of input row i
  holds the output row that reads i at tap t) with each tap's kernel
  transposed, as the JAX package's ``_conv_sym`` / ``_conv_revgeo`` take
  it; d_weights is kernel K16 (``csrc/sparse_dweights.cu``, float32 or
  bfloat16 rows and output gradient, float32 sums), ``dW[t] = sum over
  rows of gather_t(feats)^T g``, on the forward table's row plan, cast to
  the weights' dtype.  Under the bf16 policy both run their bf16 entries,
  each with its own count.  A reverse table and its plan are made once a table a step,
  at the first backward that asks, and shared by every convolution on the
  table; a transposed conv's reverse, the strided conv's table between the
  same two levels, is that table with the plan its forward made
  (``Reverse.of``).
* ``sparse_max_pool_batched``: the max over each output voxel's taps, as
  the chain of ``torch.maximum`` over the taps in table order
  (``sparse_max_pool_plain``, the CPU's path).  A CUDA tensor takes the
  autograd Function ``SparseMaxPool``: K17 (``csrc/sparse_pool.cu``,
  float32 or bfloat16 rows, an entry a dtype and direction, each with its
  own count) writes the output, a tie mask and each read input row's
  reader (kernel == stride: one parent a row), and its backward halves a
  tie's gradient as the chain's autograd does, each input row written once
  from its reader as the table confirms it; both equal the chain bit for
  bit (``sparse_max_pool_mask_plain``, ``sparse_max_pool_reader_plain``,
  ``sparse_max_pool_backward_plain``: its order in plain torch).

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
import struct
from typing import NamedTuple

import torch

from ._cuda import DTYPE_CODES, SM_COUNT, CudaKernel, check_cuda

_SPAN = 1290                       # per-axis key span; _SPAN**3 < 2**31
_SHIFT = 16                        # headroom for negative tap queries
INVALID = _SPAN - _SHIFT - 1       # sentinel coordinate (=1273)
MAX_COORD = _SPAN - _SHIFT - 2     # largest real coordinate
KEY_PAD = 2 ** 31 - 1              # the key of a padding row

# K13: the packed jobs (``_JOB`` each, as csrc/kernel_map.cu's Job), their
# count
KERNEL_MAP_KERNEL = CudaKernel('demf_kernel_map',
                               [ctypes.c_char_p, ctypes.c_int])
# a job: key table coords, valid, sorted keys, rows of the ranks, query
# coords, query valid, offsets, out (pointers, null where not given); B,
# M_in, Q, K, kernel size, MinkowskiEngine's tap order, stride, cell, and
# the first block (the launcher's)
_JOB = struct.Struct('<8Q9i4x')
MAX_JOBS = 8
# taps a table's row may have (a block's threads beside its 64 rows)
MAX_TAPS = 192
# K14: feats, nbr, weights, the plan's order and tile taps, scratch, out;
# B, M_in, C, M_out, K, C_out, taps a part (an entry a dtype)
SPARSE_CONV_KERNEL = CudaKernel(
    'demf_sparse_conv', [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7)
SPARSE_CONV_BF16_KERNEL = CudaKernel(
    'demf_sparse_conv_bf16', SPARSE_CONV_KERNEL.argtypes)
# K14 on a reverse table (the backward's d_feats), counted apart, an entry
# a dtype
SPARSE_CONV_BACKWARD_KERNEL = CudaKernel('demf_sparse_conv',
                                         SPARSE_CONV_KERNEL.argtypes)
SPARSE_CONV_BACKWARD_BF16_KERNEL = CudaKernel('demf_sparse_conv_bf16',
                                              SPARSE_CONV_KERNEL.argtypes)
# K16: feats, nbr, g, the plan's order and tile taps, scratch, counts, out;
# B, M_in, C, M_out, K, C_out, chunk (an entry a dtype)
SPARSE_DWEIGHTS_KERNEL = CudaKernel(
    'demf_sparse_conv_dweights', [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7)
SPARSE_DWEIGHTS_BF16_KERNEL = CudaKernel(
    'demf_sparse_conv_dweights_bf16', SPARSE_DWEIGHTS_KERNEL.argtypes)
# K14's row plan: nbr, mask, order, tile taps; B, M, K
SPARSE_CONV_PLAN_KERNEL = CudaKernel(
    'demf_sparse_conv_plan', [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3)
# K17, the max pool: rows, nbr, out_valid, out, tie mask and reverse
# index (both None in inference); B, M_in, M_out, C, K (an entry a dtype)
SPARSE_MAX_POOL_KERNEL = CudaKernel(
    'demf_sparse_max_pool', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5)
SPARSE_MAX_POOL_BF16_KERNEL = CudaKernel('demf_sparse_max_pool_bf16',
                                         SPARSE_MAX_POOL_KERNEL.argtypes)
# K17's backward: output gradient, reverse index, nbr, tie mask, d_in; B,
# M_in, M_out, C, K (an entry a dtype)
SPARSE_MAX_POOL_BACKWARD_KERNEL = CudaKernel(
    'demf_sparse_max_pool_backward',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
SPARSE_MAX_POOL_BACKWARD_BF16_KERNEL = CudaKernel(
    'demf_sparse_max_pool_backward_bf16',
    SPARSE_MAX_POOL_BACKWARD_KERNEL.argtypes)
# the taps K17 takes (a bit each in its tie mask)
MAX_POOL_TAPS = 8


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


class TableJob(NamedTuple):
    """One table of a K13 launch.  ``coords`` (B, M_in, 3) int32 and
    ``valid`` (B, M_in): the key table, in sorted-key, valid-prefix order;
    ``query_coords`` (B, Q, 3) int32 and ``query_valid`` (B, Q): the rows
    of the table, in any order.  ``cell`` 0: a convolution's table, tap t
    of a query at ``query + offset_t * stride`` (``kernel_offsets(
    kernel_size, me_order)``), (B, Q, kernel_size ** 3).  ``cell`` > 0: a
    transposed convolution's (``transposed_table``): each query's parent
    ``query // cell * cell``, held at the tap of its offset ``(query -
    parent) // stride`` (the first axis fastest), -1 at the others."""
    coords: torch.Tensor
    valid: torch.Tensor
    query_coords: torch.Tensor
    query_valid: torch.Tensor
    kernel_size: int
    me_order: bool = True
    stride: int = 1
    cell: int = 0


def kernel_tables(jobs, sorted_input=True):
    """The tables of ``jobs`` (``TableJob``s, at most ``MAX_JOBS``), a
    list of (B, Q, K) int32.  A CUDA tensor launches K13 once for all of
    them; a CPU tensor takes ``kernel_table_plain``.  Key tables that are
    not presorted (``sorted_input`` False, the tests' route) are sorted
    first, and each goes through ``kernel_map_cuda``."""
    cpu = jobs[0].query_coords.device.type == 'cpu'
    if sorted_input and not cpu:
        return kernel_tables_cuda(jobs)
    table_fn = key_table_presorted if sorted_input else build_key_table
    search = kernel_map_plain if cpu else kernel_map_cuda
    return [_table_by_search(job, *table_fn(job.coords, job.valid), search)
            for job in jobs]


def one_lookup(job):
    """A job of one lookup (the first query row of the first scene, one
    tap) on ``job``'s key table: a K13 launch with next to no work, the
    least time a launch takes."""
    return job._replace(coords=job.coords[:1].contiguous(),
                        valid=job.valid[:1].contiguous(),
                        query_coords=job.query_coords[:1, :1].contiguous(),
                        query_valid=job.query_valid[:1, :1].contiguous(),
                        kernel_size=1, cell=0)


def kernel_table_plain(job):
    """K13's function for one ``TableJob``, plain torch on any device:
    ``kernel_map_plain`` over the presorted key table."""
    return _table_by_search(job, *key_table_presorted(job.coords, job.valid),
                            kernel_map_plain)


def _table_by_search(job, skeys, order, search):
    qc = job.query_coords.to(torch.int32)
    dev = qc.device
    if not job.cell:
        return search(skeys, order, qc, job.query_valid, kernel_offsets(
            job.kernel_size, job.me_order, dev), job.stride)
    parent = torch.div(qc, job.cell, rounding_mode='floor') * job.cell
    zero = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    prow = search(skeys, order, parent, job.query_valid, zero, 1)[..., 0]
    off = torch.div(qc - parent, job.stride, rounding_mode='floor')
    k = job.kernel_size
    tap = off[..., 0] + k * (off[..., 1] + k * off[..., 2])
    taps = torch.arange(k ** 3, device=dev)
    return torch.where((tap[..., None] == taps) & (prow[..., None] >= 0),
                       prow[..., None], -1).to(torch.int32)


def kernel_tables_cuda(jobs):
    """Kernel K13 (csrc/kernel_map.cu) on at most ``MAX_JOBS`` jobs in one
    launch: int32 coordinates and bool valid flags, contiguous on the
    card."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f'a K13 launch takes 1 to {MAX_JOBS} tables, got '
                         f'{len(jobs)}')
    shapes = []
    for job in jobs:
        check_cuda('coords', job.coords, torch.int32, 3)
        check_cuda('valid', job.valid, torch.bool, 2)
        check_cuda('query_coords', job.query_coords, torch.int32, 3)
        check_cuda('query_valid', job.query_valid, torch.bool, 2)
        b, m = job.valid.shape
        q = job.query_valid.shape[1]
        k = job.kernel_size ** 3
        if job.coords.shape != (b, m, 3) or \
                job.query_coords.shape != (b, q, 3) or not 1 <= k <= MAX_TAPS:
            raise ValueError(
                f'key table {tuple(job.coords.shape)} / '
                f'{tuple(job.valid.shape)}, queries '
                f'{tuple(job.query_coords.shape)} / '
                f'{tuple(job.query_valid.shape)} and kernel size '
                f'{job.kernel_size} do not go together')
        shapes.append((b, q, k))
    dev = jobs[0].coords.device
    outs = [torch.empty(shape, dtype=torch.int32, device=dev)
            for shape in shapes]
    if any(out.numel() for out in outs):
        KERNEL_MAP_KERNEL(b''.join(
            _JOB.pack(j.coords.data_ptr(), j.valid.data_ptr(), 0, 0,
                      j.query_coords.data_ptr(), j.query_valid.data_ptr(), 0,
                      out.data_ptr(), b, j.valid.shape[1], q, k,
                      j.kernel_size, int(j.me_order), int(j.stride),
                      int(j.cell), 0)
            for j, out, (b, q, k) in zip(jobs, outs, shapes)), len(jobs))
    return outs


def neighbor_table_batched(in_coords, in_valid, out_coords, out_valid,
                           offsets, in_stride=1, sorted_input=False):
    """(B, M_out, K) int32 rows of the input table (-1 = no neighbor): tap
    t of output row q reads the input row at ``out_coords[q] + offsets[t]
    * in_stride``; an invalid output row has none.  ``sorted_input``
    asserts that ``in_coords`` is in sorted-key, valid-prefix order.  A
    CUDA tensor launches K13 on the sorted keys (``kernel_map_cuda``); a
    CPU tensor takes the plain search.  The model's tables go through
    ``kernel_tables`` instead, with no torch op around the launch."""
    table_fn = key_table_presorted if sorted_input else build_key_table
    skeys, order = table_fn(in_coords, in_valid)
    offsets = offsets.to(device=out_coords.device, dtype=torch.int32)
    if out_coords.device.type == 'cpu':
        return kernel_map_plain(skeys, order, out_coords, out_valid,
                                offsets, in_stride)
    return kernel_map_cuda(skeys, order, out_coords.to(torch.int32),
                           out_valid, offsets.contiguous(), in_stride)


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
    """Kernel K13 on given sorted keys: int32 sorted keys (B, M) and, when
    the table is not presorted, their rows; int32 query coords (B, Q, 3),
    bool valid (B, Q) and int32 offsets (K, 3), all contiguous on the
    card.  One job in one launch (the tests' route and
    ``neighbor_table_batched``'s)."""
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
            offsets.shape != (k, 3) or not 1 <= k <= MAX_TAPS or (
                order is not None and order.shape != (b, m)):
        raise ValueError(
            f'keys {tuple(skeys.shape)}, queries '
            f'{tuple(query_coords.shape)}, valid {tuple(query_valid.shape)} '
            f'and offsets {tuple(offsets.shape)} do not go together')
    out = torch.empty((b, q, k), dtype=torch.int32, device=skeys.device)
    if out.numel():
        KERNEL_MAP_KERNEL(_JOB.pack(
            0, 0, skeys.data_ptr(), 0 if order is None else order.data_ptr(),
            query_coords.data_ptr(), query_valid.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), b, m, q, k, 0, 0,
            int(stride), 0, 0), 1)
    return out


# K14's tiles (csrc/sparse_conv.cu): 64 plan-ordered rows x 64 output
# channels a block, 32 input channels a stage of the walk
CONV_TILE_ROWS = 64
CONV_TILE_COLS = 64
CONV_TILE_DEPTH = 32
# the tap split: below this many blocks an SM the tap lists are cut, into
# parts that walk at least this many chunks of 32 channels
SPLIT_BELOW_BLOCKS = 8
SPLIT_MIN_CHUNKS = 16
# the plan sorts a scene's rows in chunks of this many (one block each)
PLAN_CHUNK = 16384


class ConvPlan(NamedTuple):
    """A neighbour table's row plan (``conv_plan``): ``mask`` (B, M_out)
    int32, bit t set where the row has tap t; ``order`` (B, M_out) int32,
    each scene's rows sorted stably by mask (a permutation of 0 .. M_out -
    1); ``tile_taps`` (B, ceil(M_out / 64)) int32, the taps of each tile of
    64 consecutive rows of ``order``, the OR of their masks: the tile's tap
    list, its set bits walked from the lowest."""
    mask: torch.Tensor
    order: torch.Tensor
    tile_taps: torch.Tensor


def _tap_bits(k, device):
    return torch.ones((), dtype=torch.int32, device=device) << torch.arange(
        k, dtype=torch.int32, device=device)


def conv_plan(nbr):
    """K14's row plan of a (B, M_out, K) neighbour table (K <= 32), made
    once a table and shared by every convolution that reads it.  A CUDA
    tensor launches the plan kernel (``csrc/sparse_conv.cu``), a CPU
    tensor takes ``conv_plan_plain``."""
    if nbr.device.type == 'cpu':
        return conv_plan_plain(nbr)
    return conv_plan_cuda(nbr.contiguous())


def conv_plan_plain(nbr):
    """The plan, a few torch ops: each row's mask; each scene's rows
    sorted stably by it, in chunks of ``PLAN_CHUNK`` rows (a whole scene in
    every config; tiles never straddle two chunks); each 64-row tile's OR
    of its rows' masks.  A row with no tap (padding past the valid prefix,
    an empty scene) keeps its place in the order and is written as 0."""
    b, m, k = nbr.shape
    if k > 32:
        raise ValueError(f'a tap mask holds 32 taps, the table has {k}')
    bits = _tap_bits(k, nbr.device)
    hit = nbr >= 0
    mask = torch.where(hit, bits, 0).sum(-1, dtype=torch.int32)
    chunks = -(-m // PLAN_CHUNK)
    keys = torch.full((b, chunks * PLAN_CHUNK), 1 << 32, dtype=torch.long,
                      device=nbr.device)
    keys[:, :m] = mask.long() & 0xffffffff
    order = torch.argsort(keys.reshape(b, chunks, PLAN_CHUNK), dim=2,
                          stable=True)
    order = (order + torch.arange(chunks, device=nbr.device)[:, None] *
             PLAN_CHUNK).reshape(b, -1)[:, :m]
    tiles = -(-m // CONV_TILE_ROWS)
    rows = hit.gather(1, order[..., None].expand(-1, -1, k))
    if tiles * CONV_TILE_ROWS > m:
        rows = torch.cat([rows, rows.new_zeros(
            (b, tiles * CONV_TILE_ROWS - m, k))], 1)
    tile_hit = rows.reshape(b, tiles, CONV_TILE_ROWS, k).any(2)
    tile_taps = torch.where(tile_hit, bits, 0).sum(-1, dtype=torch.int32)
    return ConvPlan(mask, order.to(torch.int32), tile_taps)


def conv_plan_cuda(nbr):
    """K14's plan kernel: int32 nbr (B, M, K) contiguous on the card ->
    the ``ConvPlan``, equal to ``conv_plan_plain``'s."""
    check_cuda('nbr', nbr, torch.int32, 3)
    b, m, k = nbr.shape
    if k > 32:
        raise ValueError(f'a tap mask holds 32 taps, the table has {k}')
    mask = torch.empty((b, m), dtype=torch.int32, device=nbr.device)
    order = torch.empty_like(mask)
    tile_taps = torch.empty((b, -(-m // CONV_TILE_ROWS)), dtype=torch.int32,
                            device=nbr.device)
    if mask.numel():
        SPARSE_CONV_PLAN_KERNEL(nbr.data_ptr(), mask.data_ptr(),
                                order.data_ptr(), tile_taps.data_ptr(), b, m,
                                k)
    return ConvPlan(mask, order, tile_taps)


def taps_a_part(b, m_out, c, c_out, k, dtype=torch.float32):
    """How many taps of a tile's list one K14 block takes (``group``): the
    whole list where the grid fills the card (``SPLIT_BELOW_BLOCKS`` x 132
    blocks) or the rows go by element (C or C_out not a multiple of a
    16-byte copy: the stem); else the fewest taps whose chunks of 32
    channels number ``SPLIT_MIN_CHUNKS`` (2 at C 256, 1 at 512), so that
    the blocks' work is even and the heaviest tile does not set the time."""
    vec = 128 // torch.finfo(dtype).bits        # elements a 16-byte copy
    blocks = b * -(-m_out // CONV_TILE_ROWS) * -(-c_out // CONV_TILE_COLS)
    if c % vec or c_out % vec or blocks >= SPLIT_BELOW_BLOCKS * SM_COUNT:
        return k
    return min(k, -(-SPLIT_MIN_CHUNKS // -(-c // CONV_TILE_DEPTH)))


class Reverse:
    """A convolution table's reverse table, for the backward's d_feats: tap
    t of input row i holds the output row that reads i at tap t (-1: none;
    an invalid row has none).  ``make`` returns it; it is made at the first
    backward that asks, with its ``conv_plan`` on the card, and kept, so
    that every convolution on the table shares one, made once a step.
    Calling the record returns (table, plan or None on the CPU)."""

    def __init__(self, make, made=None):
        self._make = make
        self._made = made

    @classmethod
    def of(cls, table, plan):
        """A reverse table that the forward has made already, with its
        ``conv_plan`` (None on the CPU): the strided conv's table read back
        by the transposed conv between the same two levels."""
        return cls(None, (table, plan))

    def __call__(self):
        if self._made is None:
            rev = self._make().contiguous()
            self._made = (rev, None if rev.device.type == 'cpu' else
                          conv_plan(rev))
        return self._made

    def taps(self, n):
        """The reverse of the table's first ``n`` taps (a stride-2 block's
        shortcut reads tap 0 of the strided table), cut from this one."""
        return Reverse(lambda: self()[0][..., :n])


def submanifold_reverse(nbr):
    """A centred odd kernel's table on one coordinate set is its own
    reverse with the taps flipped: every tap order of a centred cube is
    centrally symmetric (``offs[K - 1 - t] == -offs[t]``), as the JAX
    package's ``_conv_sym`` uses."""
    return Reverse(lambda: nbr.flip(-1))


def strided_reverse(coords, valid, out_coords, out_valid, kernel_size,
                    stride, tensor_stride=1):
    """The reverse of a strided conv's table from ``coords`` (at
    ``tensor_stride``) onto ``out_coords``: output o reads input o +
    offset_t * ts, so input i is read at tap t by output i - offset_t * ts.
    An even kernel of the stride's size (MinkResNet's 2x2x2): each input
    row's parent among the outputs at the tap of its offset
    (``parent_job``), one reader at most; a centred odd kernel (the stem's
    3x3x3): the outputs' own table at the input rows, taps flipped.  One
    K13 launch on the card."""
    if kernel_size % 2:
        job = TableJob(out_coords, out_valid, coords, valid, kernel_size,
                       True, tensor_stride)
        return Reverse(lambda: kernel_tables([job])[0].flip(-1))
    job = parent_job(coords, valid, out_coords, out_valid, stride,
                     kernel_size, tensor_stride)

    def make():
        if kernel_size != stride:
            raise ValueError(f'an even kernel ({kernel_size}) has a reverse '
                             f'table here only at its own stride, not '
                             f'{stride}')
        return kernel_tables([job])[0]
    return Reverse(make)


def transposed_reverse(coords_fine, valid_fine, coords_coarse, valid_coarse,
                       kernel_size=2, tensor_stride=1, sorted_input=True):
    """The reverse of a transposed conv's table (fine rows reading their
    parents): tap t of coarse row c holds the fine row at c + offset_t *
    ts, the strided conv's table from the fine keys onto the coarse
    queries, the same table as MinkResNet's strided conv between those
    levels.  ``sorted_input`` asserts the fine set's key order."""
    job = TableJob(coords_fine, valid_fine, coords_coarse, valid_coarse,
                   kernel_size, True, tensor_stride)
    return Reverse(lambda: kernel_tables([job], sorted_input)[0])


class SparseConv(torch.autograd.Function):
    """K14's function with its backward: ``apply(feats, weights, nbr, plan,
    rev)``.  Forward: K14 on ``plan`` (a CUDA tensor) or the plain version
    (a CPU tensor).  Backward, as ``ctx.needs_input_grad`` asks: d_feats =
    the convolution of the output gradient on ``rev`` (a ``Reverse``) with
    each tap's kernel transposed, K14 on the reverse table's plan (counted
    as ``sparse_conv_backward``, bf16 rows as ``sparse_conv_backward_bf16``);
    d_weights = ``sparse_conv_dweights`` (K16) on the forward table and
    plan, cast to the weights' dtype.  On the CPU both take the plain
    versions, never autograd of the plain forward."""

    @staticmethod
    def forward(ctx, feats, weights, nbr, plan, rev):
        ctx.save_for_backward(feats, weights)
        ctx.table = (nbr, plan, rev)
        if feats.device.type == 'cpu':
            return sparse_conv_plain(feats, nbr, weights)
        return sparse_conv_cuda(feats, nbr, weights, plan)

    @staticmethod
    def backward(ctx, g):
        feats, weights = ctx.saved_tensors
        nbr, plan, rev = ctx.table
        # the output gradient in the rows' dtype, as the JAX package casts
        # it (``_conv_sym_bwd``: ``g.astype(feats.dtype)``)
        g = g.to(feats.dtype).contiguous()
        d_feats = d_weights = None
        if ctx.needs_input_grad[0]:
            if rev is None:
                raise ValueError('the features of this convolution take a '
                                 'gradient, and it was given no reverse '
                                 'table (rev=)')
            rnbr, rplan = rev()
            wt = weights.transpose(1, 2).contiguous()
            d_feats = (sparse_conv_plain(g, rnbr, wt) if g.device.type ==
                       'cpu' else sparse_conv_backward_cuda(g, rnbr, wt,
                                                            rplan))
        if ctx.needs_input_grad[1]:
            # float32 sums, rounded to the weights' dtype here, where the
            # JAX package rounds them (``.astype(weights.dtype)``)
            d_weights = sparse_conv_dweights(feats, nbr, g, plan).to(
                weights.dtype)
        return d_feats, d_weights, None, None, None


def sparse_conv_apply_batched(feats, nbr, weights, plan=None, rev=None):
    """Gather-GEMM sparse convolution: feats (B, M, C), nbr (B, M_out, K),
    weights (K, C, C_out) -> (B, M_out, C_out) in the features' dtype (the
    weights go to it, as the JAX package casts them to the rows'), through
    ``SparseConv``.  A CUDA tensor launches K14 on ``plan`` (the table's
    ``conv_plan``, made here when not given), a CPU tensor takes the plain
    version.  ``rev`` (a ``Reverse``) is the table's reverse, which the
    backward needs when the features take a gradient."""
    weights = weights.to(feats.dtype)
    if feats.device.type != 'cpu':
        feats, nbr, weights = (feats.contiguous(), nbr.contiguous(),
                               weights.contiguous())
        if plan is None:
            plan = conv_plan(nbr)
    return SparseConv.apply(feats, weights, nbr, plan, rev)


def sparse_conv_plain(feats, nbr, weights):
    """K14's function, a tap at a time: the rows gathered (absent ones 0)
    times the tap's kernel, summed in float32 (float64 rows: in float64) in
    tap order and returned in the features' dtype (a float32 product of
    bfloat16 operands is exact, so a bfloat16 call rounds once, at the
    end)."""
    b, m, c = feats.shape
    mo, k = nbr.shape[1:]
    flat = feats.reshape(b * m, c)
    base = (torch.arange(b, device=feats.device) * m)[:, None]
    dtype = torch.promote_types(feats.dtype, torch.float32)
    acc = torch.zeros((b, mo, weights.shape[2]), dtype=dtype,
                      device=feats.device)
    for t in range(k):
        idx = nbr[..., t].long()
        g = flat[(idx.clamp(min=0) + base).reshape(-1)].reshape(b, mo, c)
        g = torch.where((idx >= 0)[..., None], g, 0).to(dtype)
        acc = acc + g @ weights[t].to(dtype)
    return acc.to(feats.dtype)


def sparse_conv_tiles_plain(feats, nbr, weights, plan, group=None):
    """K14's walk, plainly: the rows in the plan's order, each 64-row tile
    taking the taps of its list only, cut into parts of ``group`` taps as
    the kernel cuts them (part p: list positions [p G, (p + 1) G); None:
    the whole list); each part's float32 sums in tap order, the parts
    summed in order 0, 1, .., rounded once, and each row written to its own
    place ``out[b, order[i]]``.  Equal to ``sparse_conv_plain`` up to the
    order of the float32 sums."""
    b, m, c = feats.shape
    mo, k = nbr.shape[1:]
    dev = feats.device
    order = plan.order.long()
    rows = nbr.gather(1, order[..., None].expand(-1, -1, k)).long()
    listed = (plan.tile_taps[..., None] & _tap_bits(k, dev)) != 0
    pos = listed.cumsum(-1) - 1                         # place in the list
    group = group or k
    tile = torch.arange(mo, device=dev) // CONV_TILE_ROWS
    flat = feats.reshape(b * m, c)
    base = (torch.arange(b, device=dev) * m)[:, None]
    total = None
    for p in range(-(-k // group)):
        mine = listed & (pos >= p * group) & (pos < (p + 1) * group)
        acc = torch.zeros((b, mo, weights.shape[2]), dtype=torch.float32,
                          device=dev)
        for t in range(k):
            take = mine[:, tile, t] & (rows[..., t] >= 0)
            g = flat[(rows[..., t].clamp(min=0) + base).reshape(-1)]
            g = torch.where(take[..., None], g.reshape(b, mo, c), 0).float()
            acc = acc + g @ weights[t].float()
        total = acc if total is None else total + acc
    out = torch.empty_like(total)
    out.scatter_(1, order[..., None].expand_as(total), total)
    return out.to(feats.dtype)


def sparse_conv_cuda(feats, nbr, weights, plan=None, group=None):
    """Kernel K14 (csrc/sparse_conv.cu): float32 or bfloat16 feats (B, M,
    C) and weights (K, C, C_out) of one dtype, int32 nbr (B, M_out, K) and
    its ``conv_plan`` (made here when not given), all contiguous on the
    card -> (B, M_out, C_out) in their dtype.  ``group`` (the taps a part
    takes) overrides ``taps_a_part``."""
    kernel = (SPARSE_CONV_BF16_KERNEL if feats.dtype == torch.bfloat16
              else SPARSE_CONV_KERNEL)
    return _sparse_conv_launch(kernel, feats, nbr, weights, plan, group)


def sparse_conv_backward_cuda(g, rev, weights_t, plan):
    """K14 on a reverse table, the backward's d_feats: the output gradient
    (B, M_out, C_out), the reverse table (B, M_in, K) with its
    ``conv_plan`` and each tap's kernel transposed (K, C_out, C), float32
    or bfloat16 (one dtype) -> (B, M_in, C) in it, counted as
    ``sparse_conv_backward`` / ``sparse_conv_backward_bf16``."""
    kernel = (SPARSE_CONV_BACKWARD_BF16_KERNEL if g.dtype == torch.bfloat16
              else SPARSE_CONV_BACKWARD_KERNEL)
    return _sparse_conv_launch(kernel, g, rev, weights_t, plan, None)


def _sparse_conv_launch(kernel, feats, nbr, weights, plan, group):
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'feats must be float32 or bfloat16, got '
                        f'{feats.dtype}')
    check_cuda('feats', feats, feats.dtype, 3)
    check_cuda('nbr', nbr, torch.int32, 3)
    check_cuda('weights', weights, feats.dtype, 3)
    b, m, c = feats.shape
    mo, k = nbr.shape[1:]
    co = weights.shape[2]
    if nbr.shape[0] != b or weights.shape[:2] != (k, c) or k > 32:
        raise ValueError(
            f'feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)} and '
            f'weights {tuple(weights.shape)} do not go together')
    if plan is None:
        plan = conv_plan(nbr)
    check_plan(plan, b, mo)
    group = min(k, group or taps_a_part(b, mo, c, co, k, feats.dtype))
    out = torch.empty((b, mo, co), dtype=feats.dtype, device=feats.device)
    if out.numel():
        parts = -(-k // group)
        scratch = torch.empty((parts, b, mo, co), dtype=torch.float32,
                              device=feats.device) if parts > 1 else None
        kernel(feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
               plan.order.data_ptr(), plan.tile_taps.data_ptr(),
               0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
               b, m, c, mo, k, co, group)
    return out


def check_plan(plan, b, m_out):
    """Raise unless ``plan`` is the ``conv_plan`` of a (B, M_out, K) table
    on the card."""
    check_cuda('plan.order', plan.order, torch.int32, 2)
    check_cuda('plan.tile_taps', plan.tile_taps, torch.int32, 2)
    if plan.order.shape != (b, m_out) or \
            plan.tile_taps.shape != (b, -(-m_out // CONV_TILE_ROWS)):
        raise ValueError(f'the plan ({tuple(plan.order.shape)}, '
                         f'{tuple(plan.tile_taps.shape)}) is not that of a '
                         f'table of {m_out} rows in {b} scenes')


# K16's tiles (csrc/sparse_dweights.cu): 64 channels of C by 64 of C_out a
# block, or a narrow side of 8 or 16 (``dweights_widths``); its tap's rows
# in stages of 32 over the plan's tiles that list the tap, in chunks of W
# tiles a block (``dweights_chunk``), a tap's chunks summed in order by a
# second pass.  The grid aims at DWEIGHTS_BLOCKS blocks by dtype (float32
# stages take three times the tensor-core work of bf16 ones: its blocks
# are best smaller), a grid of DWEIGHTS_WHOLE blocks without chunks takes
# whole taps, and a chunk holds DWEIGHTS_MIN_CHUNK to DWEIGHTS_MAX_CHUNK
# tiles (``tools/compare_kernels.py --only sparse_dweights --sweep``, PERF.md)
DWEIGHTS_TILE = 64
DWEIGHTS_BLOCKS = {torch.float32: 32 * SM_COUNT,
                   torch.bfloat16: 8 * SM_COUNT}
DWEIGHTS_WHOLE = 8 * SM_COUNT
DWEIGHTS_MIN_CHUNK = 6
DWEIGHTS_MAX_CHUNK = 1024


def dweights_widths(c, c_out):
    """K16's tile (channels of C, channels of C_out) a block: 64 x 64, or
    where one side has at most 16 channels (the stem's C 3, a one-tap
    conv's C_out 1-10) that side at 8 or 16 (the narrower side where both
    are; C_out on a tie), the other at 64."""
    if c_out <= 16 and c_out <= c:
        return DWEIGHTS_TILE, 8 if c_out <= 8 else 16
    if c <= 16:
        return 8 if c <= 8 else 16, DWEIGHTS_TILE
    return DWEIGHTS_TILE, DWEIGHTS_TILE


def dweights_chunk(b, m_out, c, c_out, k, dtype=torch.float32):
    """How many of a tap's listed row tiles one K16 block takes (W): all
    of them where the grid (K x the tiles of C x C_out) has
    ``DWEIGHTS_WHOLE`` blocks already, else the (scene, row tile)s cut into
    as many chunks as bring it to ``DWEIGHTS_BLOCKS[dtype]``, each of at
    least ``DWEIGHTS_MIN_CHUNK`` tiles and at most ``DWEIGHTS_MAX_CHUNK``; a
    tap that lists fewer tiles than the rest fills fewer chunks (its blocks
    past them return at once)."""
    tiles = b * -(-m_out // CONV_TILE_ROWS)
    pw, qw = dweights_widths(c, c_out)
    blocks = k * -(-c // pw) * -(-c_out // qw)
    chunks = 1 if blocks >= DWEIGHTS_WHOLE else \
        -(-DWEIGHTS_BLOCKS[dtype] // blocks)
    return min(DWEIGHTS_MAX_CHUNK, max(min(tiles, DWEIGHTS_MIN_CHUNK),
                                       -(-tiles // chunks)))


def sparse_conv_dweights(feats, nbr, g, plan=None):
    """The sparse convolution's weight gradient: ``dW[t] = sum over scenes
    and output rows m of feats[b, nbr[b, m, t]]^T g[b, m]`` (absent taps
    adding 0) -> (K, C, C_out) float32.  A CUDA tensor launches K16 on the
    table's ``plan`` (made here when not given), a CPU tensor takes
    ``sparse_conv_dweights_plain``."""
    if feats.device.type == 'cpu':
        return sparse_conv_dweights_plain(feats, nbr, g)
    return sparse_conv_dweights_cuda(feats.contiguous(), nbr.contiguous(),
                                     g.contiguous(),
                                     conv_plan(nbr) if plan is None else plan)


def sparse_conv_dweights_plain(feats, nbr, g):
    """K16's function, a tap at a time: the rows gathered (absent ones 0)
    and the output gradient, one float32 ``einsum`` over scenes and rows a
    tap (float64 rows: float64; bfloat16 rows and gradient promoted to
    float32, whose products they give exactly), as the JAX package's
    ``_conv_dweights``.  The kernel sums a chunk of each tap's tiles a
    block, its rows in the plan's order, and the chunks in order 0, 1, ..;
    the two agree to a float32 rounding of the sums."""
    b, m, c = feats.shape
    k = nbr.shape[2]
    dtype = torch.promote_types(feats.dtype, torch.float32)
    flat = feats.reshape(b * m, c).to(dtype)
    base = (torch.arange(b, device=feats.device) * m)[:, None]
    gf = g.to(dtype)
    out = []
    for t in range(k):
        idx = nbr[..., t].long()
        rows = flat[(idx.clamp(min=0) + base).reshape(-1)].reshape(
            b, -1, c)
        rows = torch.where((idx >= 0)[..., None], rows, 0)
        out.append(torch.einsum('bmc,bmo->co', rows, gf))
    return torch.stack(out)


def sparse_conv_dweights_cuda(feats, nbr, g, plan, chunk=None):
    """Kernel K16 (csrc/sparse_dweights.cu): float32 or bfloat16 feats (B,
    M_in, C) and output gradient g (B, M_out, C_out) of one dtype (its own
    entry and count each), int32 nbr (B, M_out, K) with its ``conv_plan``,
    all contiguous on the card -> (K, C, C_out) float32, the same bits
    every call.  ``chunk`` (the listed tiles a block takes, 1 to
    ``DWEIGHTS_MAX_CHUNK``) overrides ``dweights_chunk``."""
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'K16 takes float32 or bfloat16 feats, got '
                        f'{feats.dtype}')
    check_cuda('feats', feats, feats.dtype, 3)
    check_cuda('nbr', nbr, torch.int32, 3)
    check_cuda('g', g, feats.dtype, 3)
    b, m, c = feats.shape
    mo, k = nbr.shape[1:]
    co = g.shape[2]
    if nbr.shape[0] != b or g.shape[:2] != (b, mo) or k > 32:
        raise ValueError(f'feats {tuple(feats.shape)}, nbr '
                         f'{tuple(nbr.shape)} and g {tuple(g.shape)} do not '
                         f'go together')
    check_plan(plan, b, mo)
    out = torch.empty((k, c, co), dtype=torch.float32, device=feats.device)
    if out.numel():
        chunk = chunk or dweights_chunk(b, mo, c, co, k, feats.dtype)
        if not 1 <= chunk <= DWEIGHTS_MAX_CHUNK:
            raise ValueError(f'a K16 block takes 1 to {DWEIGHTS_MAX_CHUNK} '
                             f'tiles, not {chunk}')
        chunks = -(-b * -(-mo // CONV_TILE_ROWS) // chunk)
        scratch = counts = None
        if chunks > 1:
            scratch = torch.empty((chunks, k, c, co), dtype=torch.float32,
                                  device=feats.device)
            counts = torch.empty(k, dtype=torch.int32, device=feats.device)
        kernel = (SPARSE_DWEIGHTS_BF16_KERNEL if feats.dtype ==
                  torch.bfloat16 else SPARSE_DWEIGHTS_KERNEL)
        kernel(feats.data_ptr(), nbr.data_ptr(), g.data_ptr(),
               plan.order.data_ptr(), plan.tile_taps.data_ptr(),
               0 if scratch is None else scratch.data_ptr(),
               0 if counts is None else counts.data_ptr(), out.data_ptr(),
               b, m, c, mo, k, co, chunk)
    return out


def submanifold_table(coords, valid, kernel_size=3, tensor_stride=1,
                      sorted_input=True):
    """A level's own (B, M, K) table, taps in MinkowskiEngine's order."""
    return kernel_tables([TableJob(coords, valid, coords, valid,
                                   kernel_size, True, tensor_stride)],
                         sorted_input)[0]


def submanifold_conv_batched(coords, valid, feats, weights, kernel_size=3,
                             tensor_stride=1, nbr=None, sorted_input=False,
                             plan=None, rev=None):
    """MinkowskiConvolution(stride=1) on the same coordinate set; ``nbr``
    may be the level's table (taps in MinkowskiEngine's order), ``plan``
    its ``conv_plan`` and ``rev`` its ``submanifold_reverse``, built once
    and shared by its convs."""
    if nbr is None:
        nbr = submanifold_table(coords, valid, kernel_size, tensor_stride,
                                sorted_input)
    if rev is None:
        rev = submanifold_reverse(nbr)
    out = sparse_conv_apply_batched(feats, nbr, weights, plan, rev)
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
                         sorted_input=False, level_kernel=None):
    """MinkowskiConvolution(kernel=k, stride=s): ``tensor_stride`` is the
    input level's granularity, the output's is ``tensor_stride * stride``
    (coords stay in finest units).  Returns (out_coords, out_valid,
    out_feats, nbr, level_nbr, plan, rev): ``nbr`` the conv's table (for an
    even kernel its tap 0 is the output voxel's own coordinate, which a
    stride-2 block's shortcut reads), ``level_nbr`` with ``level_kernel``
    the output level's own table of that size (MinkowskiEngine's order),
    made in the same K13 launch, else None; ``plan`` the conv's
    ``conv_plan`` (None on the CPU) and ``rev`` its ``strided_reverse``,
    for the callers that read the table again."""
    max_out = max_out or coords.shape[1]
    oc, ov = downsample_coords(coords, valid, stride * tensor_stride,
                               max_out)
    jobs = [TableJob(coords, valid, oc, ov, kernel_size, True,
                     tensor_stride)]
    if level_kernel:
        jobs.append(TableJob(oc, ov, oc, ov, level_kernel, True,
                             stride * tensor_stride))
    tables = kernel_tables(jobs, sorted_input)
    plan = None if feats.device.type == 'cpu' else conv_plan(tables[0])
    rev = strided_reverse(coords, valid, oc, ov, kernel_size, stride,
                          tensor_stride)
    out = sparse_conv_apply_batched(feats, tables[0], weights, plan, rev)
    return (oc, ov, torch.where(ov[..., None], out, 0), tables[0],
            tables[1] if level_kernel else None, plan, rev)


def sparse_max_pool_batched(coords, valid, feats, stride=2, kernel_size=2,
                            max_out=None, tensor_stride=1,
                            sorted_input=False):
    """MinkowskiMaxPooling(kernel=k, stride=s): the max over each output
    voxel's taps (0 where it has none).  A CPU tensor takes the chain of
    ``torch.maximum`` over the taps (``sparse_max_pool_plain``), as the JAX
    package's scan; a CUDA tensor kernel K17 (``SparseMaxPool``), which
    takes kernel == stride and at most ``MAX_POOL_TAPS`` taps and raises on
    others."""
    if feats.device.type != 'cpu' and (
            kernel_size != stride or kernel_size ** 3 > MAX_POOL_TAPS):
        raise ValueError(f'K17 pools with kernel == stride and at most '
                         f'{MAX_POOL_TAPS} taps, not kernel {kernel_size} at '
                         f'stride {stride}')
    max_out = max_out or coords.shape[1]
    oc, ov = downsample_coords(coords, valid, stride * tensor_stride,
                               max_out)
    nbr = kernel_tables([TableJob(coords, valid, oc, ov, kernel_size, False,
                                  tensor_stride)], sorted_input)[0]
    return oc, ov, sparse_max_pool(feats, nbr, ov)


def sparse_max_pool(feats, nbr, out_valid):
    """The pool's output (B, M_out, C) from its table: the chain
    (``sparse_max_pool_plain``) on a CPU tensor, K17 (``SparseMaxPool``)
    on a CUDA tensor."""
    if feats.device.type == 'cpu':
        return sparse_max_pool_plain(feats, nbr, out_valid)
    return SparseMaxPool.apply(feats, nbr, out_valid)


def _chain_max(feats, nbr):
    """(``torch.maximum`` over the taps in table order from -inf, (B,
    M_out, C); each tap's rows, -inf where the tap is absent)."""
    b, m, c = feats.shape
    flat = feats.reshape(b * m, c)
    base = (torch.arange(b, device=feats.device) * m)[:, None]
    out = feats.new_full((b, nbr.shape[1], c), float('-inf'))
    taps = []
    for t in range(nbr.shape[2]):
        idx = nbr[..., t].long()
        g = flat[(idx.clamp(min=0) + base).reshape(-1)].reshape(b, -1, c)
        taps.append(torch.where((idx >= 0)[..., None], g, float('-inf')))
        out = torch.maximum(out, taps[-1])
    return out, taps


def sparse_max_pool_plain(feats, nbr, out_valid):
    """The pool's output (B, M_out, C) from its table, as the JAX package
    takes it: ``torch.maximum`` over the taps in table order from -inf, a
    non-finite result and an invalid row 0.  Its autograd is the rule K17's
    backward follows."""
    out = _chain_max(feats, nbr)[0]
    out = torch.where(torch.isfinite(out), out, 0)
    return torch.where(out_valid[..., None], out, 0)


def sparse_max_pool_mask_plain(feats, nbr, out_valid):
    """K17's forward in plain torch: (the output, as ``sparse_max_pool_
    plain``'s; the tie mask (B, M_out, C) uint8, bit t set where tap t is
    valid and equal to the output, the output finite and its row valid)."""
    with torch.no_grad():
        acc, taps = _chain_max(feats, nbr)
        keep = torch.isfinite(acc) & out_valid[..., None]
        mask = torch.zeros(acc.shape, dtype=torch.int32, device=acc.device)
        for t, g in enumerate(taps):
            mask |= (keep & (g == acc) & (nbr[..., t:t + 1] >= 0)).int() << t
        return torch.where(keep, acc, 0), mask.to(torch.uint8)


def sparse_max_pool_reader_plain(nbr, out_valid, m_in):
    """K17's reverse index in plain torch: (B, M_in) int32, ``o * 8 + t``
    for the (output row o, tap t) of a valid output row that reads input
    row i, -1 where none does (where K17's forward writes nothing).  Needs
    one reader an input row (kernel == stride)."""
    b, m_out, k = nbr.shape
    reader = torch.full((b, m_in), -1, dtype=torch.int32, device=nbr.device)
    who = (torch.arange(m_out, dtype=torch.int32, device=nbr.device)[:, None]
           * MAX_POOL_TAPS + torch.arange(k, dtype=torch.int32,
                                          device=nbr.device))
    read = (nbr >= 0) & out_valid[..., None]
    scene = torch.arange(b, device=nbr.device)[:, None, None].expand_as(nbr)
    reader[scene[read], nbr[read].long()] = who.expand_as(nbr)[read]
    return reader


def sparse_max_pool_backward_plain(grad, nbr, mask, m_in):
    """K17's backward in plain torch, in its order: walking the taps from
    the last, a tap of the tie mask takes the running gradient halved (and
    halves it), the mask's lowest tap what is left, every other tap 0;
    each share written once as 0 + share into a zeroed (B, M_in, C), as
    the accumulating ``index_put_`` of the chain's autograd writes it.
    Needs one reader an input row (kernel == stride)."""
    b, m_out, c = grad.shape
    bits = mask.int()
    low = bits & -bits
    run = grad
    d_in = grad.new_zeros((b * m_in, c))
    base = (torch.arange(b, device=grad.device) * m_in)[:, None]
    for t in reversed(range(nbr.shape[2])):
        mine = (bits >> t) & 1 == 1
        run = torch.where(mine & (low != 1 << t), run / 2, run)
        idx = nbr[..., t].long()
        read = idx >= 0
        share = torch.where(mine, run, 0)
        d_in[(idx + base)[read]] = share[read] + 0.0
    return d_in.reshape(b, m_in, c)


def sparse_max_pool_cuda(feats, nbr, out_valid, with_mask=True):
    """Kernel K17's forward (csrc/sparse_pool.cu), one launch: float32 or
    bf16 rows (B, M_in, C), an int32 table (B, M_out, K <= 8) and bool
    out_valid (B, M_out), contiguous on the card -> (output, tie mask,
    reverse index), the last two None without ``with_mask``.  The index
    holds the reader of each input row that a valid output row reads (as
    ``sparse_max_pool_reader_plain``) and stale memory elsewhere, which the
    backward rejects against the table."""
    if feats.dtype not in DTYPE_CODES:
        raise TypeError(f'K17 takes float32 or bfloat16 rows, not '
                        f'{feats.dtype}')
    check_cuda('feats', feats, feats.dtype, 3)
    check_cuda('nbr', nbr, torch.int32, 3)
    check_cuda('out_valid', out_valid, torch.bool, 2)
    b, m_in, c = feats.shape
    m_out, k = nbr.shape[1:]
    if nbr.shape[0] != b or k > MAX_POOL_TAPS:
        raise ValueError(f'K17 takes a (B, M_out, K <= {MAX_POOL_TAPS}) '
                         f'table of rows (B, M_in, C), got '
                         f'{tuple(nbr.shape)} and {tuple(feats.shape)}')
    if out_valid.shape != (b, m_out):
        raise ValueError(f'out_valid {tuple(out_valid.shape)} does not go '
                         f'with the table {tuple(nbr.shape)}')
    out = torch.empty((b, m_out, c), dtype=feats.dtype, device=feats.device)
    mask = reader = None
    if with_mask:
        mask = torch.empty((b, m_out, c), dtype=torch.uint8,
                           device=feats.device)
        reader = torch.empty((b, m_in), dtype=torch.int32,
                             device=feats.device)
    kernel = (SPARSE_MAX_POOL_KERNEL if feats.dtype == torch.float32 else
              SPARSE_MAX_POOL_BF16_KERNEL)
    kernel(feats.data_ptr(), nbr.data_ptr(), out_valid.data_ptr(),
           out.data_ptr(), None if mask is None else mask.data_ptr(),
           None if reader is None else reader.data_ptr(), b, m_in, m_out, c,
           k)
    return out, mask, reader


def sparse_max_pool_backward_cuda(grad, reader, nbr, mask):
    """Kernel K17's backward (csrc/sparse_pool.cu), one launch: the output
    gradient (B, M_out, C) in the rows' type, the forward's reverse index
    (B, M_in), table and tie mask, contiguous on the card -> d_in (B, M_in,
    C), each row written once (an index entry counts where the table
    confirms it)."""
    if grad.dtype not in DTYPE_CODES:
        raise TypeError(f'K17 takes float32 or bfloat16 gradients, not '
                        f'{grad.dtype}')
    check_cuda('grad', grad, grad.dtype, 3)
    check_cuda('reader', reader, torch.int32, 2)
    check_cuda('nbr', nbr, torch.int32, 3)
    check_cuda('mask', mask, torch.uint8, 3)
    b, m_out, c = grad.shape
    m_in = reader.shape[1]
    if reader.shape[0] != b or mask.shape != grad.shape or \
            nbr.shape[:2] != (b, m_out) or nbr.shape[2] > MAX_POOL_TAPS:
        raise ValueError(f'grad {tuple(grad.shape)}, reverse index '
                         f'{tuple(reader.shape)}, table {tuple(nbr.shape)} '
                         f'and mask {tuple(mask.shape)} do not go together')
    d_in = torch.empty((b, m_in, c), dtype=grad.dtype, device=grad.device)
    kernel = (SPARSE_MAX_POOL_BACKWARD_KERNEL if grad.dtype == torch.float32
              else SPARSE_MAX_POOL_BACKWARD_BF16_KERNEL)
    kernel(grad.data_ptr(), reader.data_ptr(), nbr.data_ptr(),
           mask.data_ptr(), d_in.data_ptr(), b, m_in, m_out, c, nbr.shape[2])
    return d_in


class SparseMaxPool(torch.autograd.Function):
    """The pool's output from its table and out_valid on the card: K17's
    forward (it writes the tie mask and the reverse index when the rows
    take a gradient) and its backward (it reads them).  Both equal the
    chain's output and its autograd bit for bit, as their plain versions
    do (``sparse_max_pool_mask_plain``,
    ``sparse_max_pool_backward_plain``)."""

    @staticmethod
    def forward(ctx, feats, nbr, out_valid):
        out, mask, reader = sparse_max_pool_cuda(
            feats.contiguous(), nbr, out_valid, ctx.needs_input_grad[0])
        ctx.save_for_backward(reader, nbr, mask)
        return out

    @staticmethod
    def backward(ctx, grad):
        reader, nbr, mask = ctx.saved_tensors
        return (sparse_max_pool_backward_cuda(grad.contiguous(), reader, nbr,
                                              mask), None, None)


def parent_job(coords_fine, valid_fine, coords_coarse, valid_coarse,
               stride=2, kernel_size=2, tensor_stride=1):
    """The ``TableJob`` of a transposed conv's table onto a known fine
    set: each fine voxel's parent ``coords_fine // cs * cs`` (``cs =
    stride * tensor_stride``) found among the coarse voxels and held at the
    tap of its offset ``(fine - parent) // tensor_stride`` (the first axis
    fastest); each row has one tap at most."""
    return TableJob(coords_coarse, valid_coarse, coords_fine, valid_fine,
                    kernel_size, True, tensor_stride, stride * tensor_stride)


def transposed_table(coords_fine, valid_fine, coords_coarse, valid_coarse,
                     stride=2, kernel_size=2, tensor_stride=1,
                     sorted_input=False):
    """The (B, M_f, K) table of a transposed conv onto a known fine set
    (``parent_job``), one K13 launch on the card."""
    return kernel_tables([parent_job(coords_fine, valid_fine, coords_coarse,
                                     valid_coarse, stride, kernel_size,
                                     tensor_stride)], sorted_input)[0]


def transposed_conv_to_batched(coords_fine, valid_fine, coords_coarse,
                               valid_coarse, feats_coarse, weights, stride=2,
                               kernel_size=2, tensor_stride=1,
                               sorted_input=False, nbr=None, rev=None):
    """MinkowskiConvolutionTranspose(kernel=2, stride=2) onto a known fine
    coordinate set (the encoder skip's table), as FCAF3D's decoder
    upsamples: the ``transposed_table`` (or ``nbr``, that table made
    beforehand) goes through K14.  ``tensor_stride`` is the fine level's
    granularity; ``rev`` the table's ``Reverse`` (``transposed_reverse``
    by default)."""
    if nbr is None:
        nbr = transposed_table(coords_fine, valid_fine, coords_coarse,
                               valid_coarse, stride, kernel_size,
                               tensor_stride, sorted_input)
    if rev is None:
        rev = transposed_reverse(coords_fine, valid_fine, coords_coarse,
                                 valid_coarse, kernel_size, tensor_stride,
                                 sorted_input)
    out = sparse_conv_apply_batched(feats_coarse, nbr, weights, rev=rev)
    return torch.where(valid_fine[..., None], out, 0)


def global_max_pool(feats, valid):
    """(M, C) -> (C,) the max over the valid rows."""
    return torch.where(valid[:, None], feats, float('-inf')).max(0).values
