"""Multi-scale deformable attention core: CUDA kernels K3 (forward) and K4
(backward), and their plain version.

Port of ``demf_tpu/ops/msda.py::multi_scale_deformable_attention``:
bilinear reads with ``align_corners=False`` and zero padding at the
sampling locations, weighted by the attention weights, accumulated in fp32.
On a CUDA tensor that needs a gradient the op is ``MSDAFunction``: K3 runs
the forward and K4 returns ``d_value``, ``d_sampling_locations`` and
``d_attention_weights``.  The plain version's gradient is its own autograd
(gathers, whose backward is a scatter-add).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._cuda import CudaKernel, check_cuda

MSDA_KERNEL = CudaKernel(
    'demf_msda_forward', [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7)
MSDA_BACKWARD_KERNEL = CudaKernel(
    'demf_msda_backward', [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7)


def multi_scale_deformable_attention(value, spatial_shapes,
                                     sampling_locations, attention_weights):
    """value (B, sum_HW, heads, hd), static ``spatial_shapes`` ((h, w), ...),
    sampling_locations (B, Q, heads, L, P, 2) in [0, 1], attention_weights
    (B, Q, heads, L, P) -> (B, Q, heads * hd).

    A CPU tensor takes the plain version; a CUDA tensor the kernels (K3,
    and K4 in the backward when an input requires grad).
    """
    if value.device.type == 'cpu':
        return msda_plain(value, spatial_shapes, sampling_locations,
                          attention_weights)
    args = (value.contiguous(), spatial_shapes,
            sampling_locations.contiguous(), attention_weights.contiguous())
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations,
                                      attention_weights)):
        return MSDAFunction.apply(*args)
    return msda_cuda(*args)


def _bilinear_sample(rows, loc_xy, h, w):
    """Zero-padded align_corners=False bilinear read.

    rows (N, H*W, hd), loc_xy (N, S, 2) in [0, 1] -> (N, S, hd).
    """
    x = loc_xy[..., 0] * w - 0.5
    y = loc_xy[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0 = x0.long()
    y0 = y0.long()
    out = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            xi = x0 + dx
            yi = y0 + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            g = torch.gather(rows, 1, idx[..., None].expand(
                -1, -1, rows.shape[-1]))
            out = out + g * (wx * wy * ok)[..., None]
    return out


def msda_plain(value, spatial_shapes, sampling_locations, attention_weights):
    """Plain PyTorch MSDA (the reference's ``t_bilinear_sample`` form)."""
    b, _, heads, hd = value.shape
    q = sampling_locations.shape[1]
    npts = sampling_locations.shape[4]
    out = value.new_zeros(b, heads, q, hd, dtype=torch.float32)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        rows = value[:, start:start + h * w].float().permute(0, 2, 1, 3)
        rows = rows.reshape(b * heads, h * w, hd)
        loc = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4)
        loc = loc.reshape(b * heads, q * npts, 2).float()
        sampled = _bilinear_sample(rows, loc, h, w).reshape(
            b, heads, q, npts, hd)
        a = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).float()
        out = out + (sampled * a[..., None]).sum(3)
        start += h * w
    return out.permute(0, 2, 1, 3).reshape(b, q, heads * hd).to(value.dtype)


def _check_args(value, spatial_shapes, sampling_locations,
                attention_weights):
    """Validate the kernels' inputs; returns the level table (H, W, start)
    as an int32 tensor on the device."""
    check_cuda('value', value, torch.float32, 4)
    check_cuda('sampling_locations', sampling_locations, torch.float32, 6)
    check_cuda('attention_weights', attention_weights, torch.float32, 5)
    b, s, heads, hd = value.shape
    _, q, _, levels, points, _ = sampling_locations.shape
    if tuple(sampling_locations.shape) != (b, q, heads, levels, points, 2):
        raise ValueError(f'sampling_locations '
                         f'{tuple(sampling_locations.shape)} do not match '
                         f'value {tuple(value.shape)}')
    if tuple(attention_weights.shape) != (b, q, heads, levels, points):
        raise ValueError(f'attention_weights {tuple(attention_weights.shape)}'
                         f' do not match sampling_locations')
    if len(spatial_shapes) != levels:
        raise ValueError(f'{len(spatial_shapes)} spatial shapes for '
                         f'{levels} levels')
    info, start = [], 0
    for (h, w) in spatial_shapes:
        info += [int(h), int(w), start]
        start += int(h) * int(w)
    if start != s:
        raise ValueError(f'spatial shapes cover {start} tokens, value has {s}')
    return torch.tensor(info, dtype=torch.int32).to(value.device,
                                                    non_blocking=True)


def msda_cuda(value, spatial_shapes, sampling_locations, attention_weights):
    """Kernel K3 (csrc/msda.cu): the forward, no autograd."""
    level_info = _check_args(value, spatial_shapes, sampling_locations,
                             attention_weights)
    b, s, heads, hd = value.shape
    _, q, _, levels, points, _ = sampling_locations.shape
    out = torch.empty((b, q, heads * hd), dtype=torch.float32,
                      device=value.device)
    MSDA_KERNEL(value.data_ptr(), level_info.data_ptr(),
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                out.data_ptr(), b, s, q, heads, hd, levels, points)
    return out


def msda_backward_cuda(value, spatial_shapes, sampling_locations,
                       attention_weights, grad_out):
    """Kernel K4 (csrc/msda_backward.cu): grad_out (B, Q, heads * hd) ->
    (d_value, d_sampling_locations, d_attention_weights).  head_dim must
    divide 32."""
    level_info = _check_args(value, spatial_shapes, sampling_locations,
                             attention_weights)
    b, s, heads, hd = value.shape
    _, q, _, levels, points, _ = sampling_locations.shape
    if hd > 32 or 32 % hd:
        raise ValueError(f'the MSDA backward kernel needs a head_dim that '
                         f'divides 32, got {hd}')
    check_cuda('grad_out', grad_out, torch.float32, 3)
    if tuple(grad_out.shape) != (b, q, heads * hd):
        raise ValueError(f'grad_out {tuple(grad_out.shape)} does not match '
                         f'({b}, {q}, {heads * hd})')
    d_value = torch.zeros_like(value)
    d_locs = torch.empty_like(sampling_locations)
    d_aw = torch.empty_like(attention_weights)
    MSDA_BACKWARD_KERNEL(
        value.data_ptr(), level_info.data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), d_value.data_ptr(), d_locs.data_ptr(),
        d_aw.data_ptr(), b, s, q, heads, hd, levels, points)
    return d_value, d_locs, d_aw


class MSDAFunction(torch.autograd.Function):
    """MSDA on CUDA tensors with a gradient: K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msda_cuda(value, spatial_shapes, sampling_locations,
                         attention_weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, locs, aw = ctx.saved_tensors
        d_value, d_locs, d_aw = msda_backward_cuda(
            value, ctx.spatial_shapes, locs, aw, grad_out.contiguous())
        return d_value, None, d_locs, d_aw
