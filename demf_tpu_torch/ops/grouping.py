"""Ball query (CUDA kernel K2 and its plain version) and point grouping.

Port of ``demf_tpu/ops/grouping.py`` with the ``exact=True`` semantics: the
``nsample`` nearest points with ``d2 < r^2``, in ascending (d2, index)
order; missing slots repeat the first hit and an empty neighbourhood gives
index 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._cuda import SMEM_PER_BLOCK, SM_COUNT, CudaKernel, check_cuda

# csrc/ball_query.cu: points, centers, out; B, N, M, K; r^2; warps in a
# block, centers a warp, keys a list, points a tile
BALL_QUERY_KERNEL = CudaKernel(
    'demf_ball_query', [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 +
    [ctypes.c_float] + [ctypes.c_int] * 4)
# (warps, centers a warp) of a block, most centers first; a warp's centers
# live in its registers
BALL_QUERY_BLOCKS = ((16, 2), (8, 4), (8, 2), (4, 2), (2, 1), (1, 1))
# a scene above this many points is bound by the pair tests, below by the
# latency of one block
BALL_QUERY_LONG_SCENE = 4096


def sqdist(a, b):
    """(..., M, 3) x (..., N, 3) -> (..., M, N) as max(a2 + b2 - 2ab, 0),
    the formula of ``grouping._sqdist``."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return (a2 + b2 - 2 * ab).clamp_min(0.0)


def sqdist_unfused(a, b):
    """``sqdist`` with the dot product written out, each product and sum
    rounded on its own in the kernel's order: the kernel's distances bit
    for bit.  For checks of the kernel; (..., M, N) float32."""
    ax, ay, az = (a[..., :, None, i] for i in range(3))
    bx, by, bz = (b[..., None, :, i] for i in range(3))
    a2 = ax * ax + ay * ay + az * az
    b2 = bx * bx + by * by + bz * bz
    ab = ax * bx + ay * by + az * bz
    return ((a2 + b2) - 2 * ab).clamp_min(0.0)


def ball_query(radius, nsample, points_xyz, centers_xyz):
    """(B, N, 3) points, (B, M, 3) centers -> (B, M, nsample) int64.

    A CPU tensor takes the plain version; a CUDA tensor the kernel.
    """
    if points_xyz.device.type == 'cpu':
        return ball_query_plain(radius, nsample, points_xyz, centers_xyz)
    return ball_query_cuda(radius, nsample, points_xyz.contiguous(),
                           centers_xyz.contiguous())


def ball_query_plain(radius, nsample, points_xyz, centers_xyz,
                     distances=sqdist):
    """Distance matrix + stable sort (ties keep the lower index)."""
    d2 = distances(centers_xyz.float(), points_xyz.float())   # (B, M, N)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    inside = d2 < r2
    keys = torch.where(inside, d2, torch.full_like(d2, float('inf')))
    k = min(nsample, keys.shape[-1])
    _, order = torch.sort(keys, dim=-1, stable=True)
    idx = order[..., :k]
    has = torch.gather(inside, -1, idx)
    if k < nsample:
        pad = nsample - k
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], -1)
        has = torch.cat([has, has.new_zeros(has.shape[:-1] + (pad,))], -1)
    first = torch.where(has[..., :1], idx[..., :1], torch.zeros_like(
        idx[..., :1]))
    return torch.where(has, idx, first)


def ball_query_streamed_plain(radius, nsample, points_xyz, centers_xyz, tile,
                              cap, distances=sqdist):
    """The kernel's selection rule in plain Python, on ``distances``: a
    center takes the points tile by tile, 32 at a time in index order, and
    appends those with ``d2 < threshold`` (r^2 at first)
    to a list of at most ``cap`` keys; when the next 32 might not fit it
    sorts the list by (d2, index), keeps the ``nsample`` smallest and
    lowers the threshold to the last kept distance (a strict ``<``: a later
    tie has a larger index and would sort behind it).  Equal to
    ``ball_query_plain``; for tests, one center at a time."""
    if cap < nsample + 32 or tile % 32:
        raise ValueError(f'need cap >= nsample + 32 and tile % 32 == 0, got '
                         f'cap {cap}, nsample {nsample}, tile {tile}')
    d2 = distances(centers_xyz.float(), points_xyz.float())   # (B, M, N)
    b, m, n = d2.shape
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    out = torch.zeros((b, m, nsample), dtype=torch.int64)
    for bi in range(b):
        for mi in range(m):
            row = d2[bi, mi].tolist()
            keys, threshold = [], r2
            for t0 in range(0, n, tile):
                for j0 in range(t0, min(t0 + tile, n), 32):
                    keys += [(row[j], j) for j in range(j0, min(j0 + 32, n))
                             if row[j] < threshold]
                    if len(keys) > cap - 32:
                        keys = sorted(keys)[:nsample]
                        threshold = keys[-1][0]
            picks = [j for _, j in sorted(keys)[:nsample]]
            pad = picks[0] if picks else 0
            out[bi, mi] = torch.tensor(picks + [pad] * (nsample - len(picks)))
    return out


def ball_query_smem_bytes(warps, centers_per_warp, cap, tile):
    """Shared memory of one block of the kernel: the centers' lists of
    64-bit keys, two raw point tiles (xyz and the scene's shift) and one
    tile of (x, y, z, |p|^2)."""
    return warps * centers_per_warp * cap * 8 + 2 * (3 * tile + 4) * 4 + \
        16 * tile


@functools.lru_cache(maxsize=None)
def ball_query_launch_shape(b, m, n, k):
    """(warps in a block, centers a warp, keys a list, points a tile) for
    B scenes of M centers and N points and K picks.

    A block streams its scene's points once for all its centers, so many
    centers a block read and execute less for a pair, and few leave more
    blocks to fill the card.  A long scene takes 8 warps x 4 centers and
    tiles of 1,024 points while that gives every SM two blocks, else 16
    warps x 2 and tiles of 2,048 (batch 2: one block an SM, twice the
    warps); a short scene 8 x 2, 16 x 2 or 4 x 2 by the number of centers
    and tiles of 1,024.  A list holds 128 keys, or the next power of two
    above K + 32.  Chosen among the shapes timed on an NVIDIA H100 at the
    models' five shapes, two densities, batch 16 and 2 (``python -m
    demf_tpu_torch.tools.compare_kernels --sweep``).  A block whose shared
    memory does not fit gives way to a smaller one; raises where none
    holds one center's list.
    """
    if min(b, m, n, k) < 1:
        raise ValueError(f'need B, M, N, K >= 1, got {b}, {m}, {n}, {k}')
    cap = 128
    while cap < k + 32:
        cap *= 2
    centers = b * m
    if n > BALL_QUERY_LONG_SCENE:
        first, tile = (1, 1024) if centers >= 64 * SM_COUNT else (0, 2048)
    else:
        first = 2 if centers >= 16384 else 0 if centers >= 8192 else 3
        tile = min(1024, -(-n // 32) * 32)
    best = BALL_QUERY_BLOCKS[first]
    for warps, per_warp in (best,) + tuple(
            blk for blk in BALL_QUERY_BLOCKS
            if blk[0] * blk[1] < best[0] * best[1]):
        if ball_query_smem_bytes(warps, per_warp, cap, tile) <= \
                SMEM_PER_BLOCK:
            return warps, per_warp, cap, tile
    raise ValueError(f'ball query kernel: a list of {cap} keys for K = {k} '
                     f'does not fit a block\'s shared memory')


def ball_query_cuda(radius, nsample, points_xyz, centers_xyz):
    """Kernel K2 (csrc/ball_query.cu)."""
    check_cuda('points_xyz', points_xyz, torch.float32, 3)
    check_cuda('centers_xyz', centers_xyz, torch.float32, 3)
    b, n, c = points_xyz.shape
    bc, m, cc = centers_xyz.shape
    if c != 3 or cc != 3 or bc != b:
        raise ValueError(f'expected (B, N, 3) and (B, M, 3), got '
                         f'{tuple(points_xyz.shape)}, '
                         f'{tuple(centers_xyz.shape)}')
    if points_xyz.device != centers_xyz.device:
        raise ValueError('points and centers must be on one device')
    if nsample < 1 or n < 1:
        raise ValueError(f'need nsample >= 1 and N >= 1, got {nsample}, {n}')
    out = torch.empty((b, m, nsample), dtype=torch.int64,
                      device=points_xyz.device)
    if b == 0 or m == 0:
        return out
    shape = ball_query_launch_shape(b, m, n, nsample)
    if points_xyz.data_ptr() % 16:      # the kernel copies 16 bytes at a time
        points_xyz = points_xyz.clone()
    BALL_QUERY_KERNEL(points_xyz.data_ptr(), centers_xyz.data_ptr(),
                      out.data_ptr(), b, n, m, nsample,
                      float(radius) * float(radius), *shape)
    return out


def gather_points_last(arr, idx):
    """Gather rows: arr (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(arr, 1, idx[..., None].expand(-1, -1, arr.shape[-1]))


def group_points_last(arr, idx):
    """Gather neighbourhoods: arr (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    return gather_points_last(arr, idx.reshape(b, m * s)).reshape(
        b, m, s, arr.shape[-1])


def gather_points(features, indices):
    """mmdet3d ``gather_points``: (B, C, N), (B, M) -> (B, C, M)."""
    return torch.gather(features, 2, indices[:, None, :].expand(
        -1, features.shape[1], -1))


def group_points(features, indices):
    """mmdet3d ``grouping_operation``: (B, C, N), (B, M, S) -> (B, C, M, S)."""
    b, c, _ = features.shape
    m, s = indices.shape[1:]
    flat = indices.reshape(b, 1, m * s).expand(-1, c, -1)
    return torch.gather(features, 2, flat).reshape(b, c, m, s)


def query_and_group(points_xyz, centers_xyz, features, radius, nsample,
                    use_xyz=True, normalize_xyz=False):
    """Ball query + neighbour gather + recenter (mmdet3d QueryAndGroup).

    points_xyz (B, N, 3), centers_xyz (B, M, 3), features (B, C, N) or
    None -> ((B, C', M, nsample), idx) with C' = 3 + C when use_xyz.
    """
    idx = ball_query(radius, nsample, points_xyz, centers_xyz)
    grouped_xyz = group_points(points_xyz.transpose(1, 2), idx)
    grouped_xyz = grouped_xyz - centers_xyz.transpose(1, 2)[..., None]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is not None:
        grouped_feats = group_points(features, idx)
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_feats], 1), idx
        return grouped_feats, idx
    if not use_xyz:
        raise ValueError('cannot group without features and without xyz')
    return grouped_xyz, idx
