"""Ball query (CUDA kernel K2 and its plain version) and point grouping.

Port of ``demf_tpu/ops/grouping.py`` with the ``exact=True`` semantics: the
``nsample`` nearest points with ``d2 < r^2``, in ascending (d2, index)
order; missing slots repeat the first hit and an empty neighbourhood gives
index 0.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda

BALL_QUERY_KERNEL = CudaKernel(
    'demf_ball_query', [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_float])


def sqdist(a, b):
    """(..., M, 3) x (..., N, 3) -> (..., M, N) as max(a2 + b2 - 2ab, 0),
    the formula of ``grouping._sqdist``."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return (a2 + b2 - 2 * ab).clamp_min(0.0)


def ball_query(radius, nsample, points_xyz, centers_xyz):
    """(B, N, 3) points, (B, M, 3) centers -> (B, M, nsample) int64.

    A CPU tensor takes the plain version; a CUDA tensor the kernel.
    """
    if points_xyz.device.type == 'cpu':
        return ball_query_plain(radius, nsample, points_xyz, centers_xyz)
    return ball_query_cuda(radius, nsample, points_xyz.contiguous(),
                           centers_xyz.contiguous())


def ball_query_plain(radius, nsample, points_xyz, centers_xyz):
    """Distance matrix + stable sort (ties keep the lower index)."""
    d2 = sqdist(centers_xyz.float(), points_xyz.float())     # (B, M, N)
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
    BALL_QUERY_KERNEL(points_xyz.data_ptr(), centers_xyz.data_ptr(),
                      out.data_ptr(), b, n, m, nsample,
                      float(radius) * float(radius))
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
