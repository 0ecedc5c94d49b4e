"""Multi-scale deformable attention core: CUDA kernels K3 (forward) and K4
(backward), and their plain version.

Port of ``demf_tpu/ops/msda.py::multi_scale_deformable_attention``:
bilinear reads with ``align_corners=False`` and zero padding at the
sampling locations, weighted by the attention weights, accumulated in fp32.
On a CUDA tensor that needs a gradient the op is ``MSDAFunction``: K3 runs
the forward and K4 returns ``d_value``, ``d_sampling_locations`` and
``d_attention_weights``.  The plain version's gradient is its own autograd
(gathers, whose backward is a scatter-add).

The value (and with it the output, ``grad_out`` and ``d_value``) is float32
or bfloat16, each kernel reading it in its own type (the ``_bf16`` entry
points of the same sources); locations and weights are float32, and so are
every sum and ``d_loc`` / ``d_aw``.  Under the bf16 policy the locations
arrive float32 everywhere (float32 reference points plus the offsets), and
so do the weights of the encoders and the DeMF decoder (their queries
carry a float32 position); the DETR head's decoder gives bf16 weights (its
learned query position is a bf16 weight, as in the JAX package), which the
op widens to float32, exactly, before the kernels.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ._cuda import CudaKernel, check_cuda

MSDA_KERNEL = CudaKernel(
    'demf_msda_forward', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10)
MSDA_BACKWARD_KERNEL = CudaKernel(
    'demf_msda_backward', [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10)
# the same kernels on a bfloat16 value; K4's takes a float32 buffer for
# d_value's sums beside the bfloat16 d_value it rounds them into
MSDA_BF16_KERNEL = CudaKernel(
    'demf_msda_forward_bf16', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10)
MSDA_BACKWARD_BF16_KERNEL = CudaKernel(
    'demf_msda_backward_bf16', [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10)
VALUE_DTYPES = (torch.float32, torch.bfloat16)

# csrc/msda.cu (K4 takes the same tiles): threads of a block, queries of a
# tile that one thread sums,
# the side of a tile on the finest level (a tile holds at most its square),
# the fewest queries worth a tile, the most points a level whose locations
# still leave a tile's window room in shared memory.  The kernel's entry
# point is told the largest tile and refuses one beyond its own limits.
MSDA_THREADS = 512
MSDA_MAX_PASSES = 4
MSDA_TILE_SIDE = 16
MSDA_MIN_TILE = 64
MSDA_MAX_TILE_POINTS = 16
# csrc/msda_backward.cu: the most points a level of a tile's queries
MSDA_BACKWARD_MAX_TILE_POINTS = 4

# (spatial shapes, head_dim, tiled, device) -> (level table, tile table,
# tiles, direct_from, max_tile) with the tables on the device: built once, not copied
# from the host at every call
_TABLES = {}


def multi_scale_deformable_attention(value, spatial_shapes,
                                     sampling_locations, attention_weights):
    """value (B, sum_HW, heads, hd), static ``spatial_shapes`` ((h, w), ...),
    sampling_locations (B, Q, heads, L, P, 2) in [0, 1], attention_weights
    (B, Q, heads, L, P) -> (B, Q, heads * hd) in the value's dtype.

    A CPU tensor takes the plain version; a CUDA tensor the kernels (K3,
    and K4 in the backward when an input requires grad).
    """
    if value.device.type == 'cpu':
        return msda_plain(value, spatial_shapes, sampling_locations,
                          attention_weights)
    args = (value.contiguous(), spatial_shapes,
            sampling_locations.float().contiguous(),
            attention_weights.float().contiguous())
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


def msda_tiling(spatial_shapes, head_dim):
    """How K3 cuts the levels' own tokens, as queries, into spatial tiles.

    Returns (rows, tiles, direct_from): ``rows`` holds one (tile H, tile W,
    tiles across, tiles of the level, first tile of the level) per level;
    ``tiles`` is their number over all levels; the queries from token
    ``direct_from`` on belong to no tile and take the kernel's query-major
    mapping.  A tile covers about ``MSDA_TILE_SIDE`` squared pixels of the
    first level, whatever its own level, so that its samples' window on
    each level stays small; a tile's queries fit the kernel's
    ``MSDA_MAX_PASSES`` passes of ``MSDA_THREADS / (head_dim / 4)`` queries
    and its ``MSDA_TILE_SIDE`` squared slots for locations; a level whose
    tiles would hold fewer than ``MSDA_MIN_TILE`` queries is left to the
    query-major mapping, and every level after it too.
    """
    most = min(MSDA_TILE_SIDE ** 2,
               MSDA_MAX_PASSES * (MSDA_THREADS // (head_dim // 4)))
    side_w = MSDA_TILE_SIDE
    side_h = max(1, min(MSDA_TILE_SIDE, most // side_w))
    h0, w0 = spatial_shapes[0]
    rows, tiles, direct_from, tiled = [], 0, 0, True
    for h, w in spatial_shapes:
        th = max(1, min(h, round(side_h * h / h0)))
        tw = max(1, min(w, round(side_w * w / w0)))
        tiled = tiled and MSDA_MIN_TILE <= th * tw <= most
        if tiled:
            across, down = -(-w // tw), -(-h // th)
            rows.append((th, tw, across, across * down, tiles))
            tiles += across * down
            direct_from += h * w
        else:
            rows.append((0, 0, 0, 0, tiles))
    return rows, tiles, direct_from


def _tables(spatial_shapes, head_dim, tiled, device):
    """The kernels' level table (H, W, first token) and K3's tile table as
    int32 tensors on ``device``, with K3's tile count, ``direct_from`` and
    the most queries of any tile (all 0 unless ``tiled``)."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    key = (shapes, head_dim, tiled, device)
    if key not in _TABLES:
        info, start = [], 0
        for h, w in shapes:
            info.append((h, w, start))
            start += h * w
        rows, tiles, direct_from = msda_tiling(shapes, head_dim)
        if not tiled or not tiles:
            rows, tiles, direct_from = [(0,) * 5] * len(shapes), 0, 0
        _TABLES[key] = (
            torch.tensor(info, dtype=torch.int32).to(device),
            torch.tensor(rows, dtype=torch.int32).to(device),
            tiles, direct_from, max(th * tw for th, tw, *_ in rows))
    return _TABLES[key]


def _check_args(value, spatial_shapes, sampling_locations,
                attention_weights):
    """Validate the kernels' inputs: a float32 or bfloat16 value, float32
    locations and weights."""
    if value.dtype not in VALUE_DTYPES:
        raise TypeError(f'value must be float32 or bfloat16, got '
                        f'{value.dtype}')
    check_cuda('value', value, value.dtype, 4)
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
    covered = sum(int(h) * int(w) for h, w in spatial_shapes)
    if covered != s:
        raise ValueError(f'spatial shapes cover {covered} tokens, value has '
                         f'{s}')


def msda_cuda(value, spatial_shapes, sampling_locations, attention_weights):
    """Kernel K3 (csrc/msda.cu): the forward, no autograd.  Where there is
    one query per token (Q == sum_HW: the encoder's self-attention, whose
    query i is token i) the tokens of the finer levels go through the
    kernel's spatial tiles; that choice moves the speed only, any
    locations give the same result.  The output has the value's dtype: a
    bfloat16 value runs the kernel's bfloat16 entry, 8 channels a thread,
    so its head_dim is 8 times a divisor of ``MSDA_THREADS``."""
    _check_args(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, heads, hd = value.shape
    _, q, _, levels, points, _ = sampling_locations.shape
    lanes = 16 // value.element_size()
    if hd < lanes or hd % lanes or MSDA_THREADS % (hd // lanes):
        raise ValueError(f'the MSDA forward kernel needs a head_dim that is '
                         f'{lanes} times a divisor of {MSDA_THREADS} in '
                         f'{value.dtype}, got {hd}')
    level_info, tile_info, tiles, direct_from, max_tile = _tables(
        spatial_shapes, hd, q == s and points <= MSDA_MAX_TILE_POINTS,
        value.device)
    out = torch.empty((b, q, heads * hd), dtype=value.dtype,
                      device=value.device)
    kernel = MSDA_KERNEL if value.dtype == torch.float32 else MSDA_BF16_KERNEL
    kernel(value.data_ptr(), level_info.data_ptr(), tile_info.data_ptr(),
           sampling_locations.data_ptr(), attention_weights.data_ptr(),
           out.data_ptr(), b, s, q, heads, hd, levels, points, tiles,
           direct_from, max_tile)
    return out


def msda_backward_cuda(value, spatial_shapes, sampling_locations,
                       attention_weights, grad_out):
    """Kernel K4 (csrc/msda_backward.cu): grad_out (B, Q, heads * hd) ->
    (d_value, d_sampling_locations, d_attention_weights).  head_dim must
    divide 32.  As in ``msda_cuda``, with one query per token the tokens of
    the finer levels go through the kernel's spatial tiles (K3's), which
    sum a tile's additions to d_value row by row before they reach global
    memory; that moves the speed only.  ``grad_out`` and ``d_value`` have
    the value's dtype; a bfloat16 d_value is summed in a float32 buffer and
    rounded once (its tiles need a head_dim that is a multiple of 8)."""
    _check_args(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, heads, hd = value.shape
    _, q, _, levels, points, _ = sampling_locations.shape
    if hd > 32 or 32 % hd:
        raise ValueError(f'the MSDA backward kernel needs a head_dim that '
                         f'divides 32, got {hd}')
    level_info, tile_info, tiles, direct_from, max_tile = _tables(
        spatial_shapes, hd,
        q == s and hd % (16 // value.element_size()) == 0 and
        points <= MSDA_BACKWARD_MAX_TILE_POINTS, value.device)
    check_cuda('grad_out', grad_out, value.dtype, 3)
    if tuple(grad_out.shape) != (b, q, heads * hd):
        raise ValueError(f'grad_out {tuple(grad_out.shape)} does not match '
                         f'({b}, {q}, {heads * hd})')
    d_locs = torch.empty_like(sampling_locations)
    d_aw = torch.empty_like(attention_weights)
    ints = (b, s, q, heads, hd, levels, points, tiles, direct_from, max_tile)
    ptrs = (value.data_ptr(), level_info.data_ptr(), tile_info.data_ptr(),
            sampling_locations.data_ptr(), attention_weights.data_ptr(),
            grad_out.data_ptr())
    if value.dtype == torch.float32:
        d_value = torch.zeros_like(value)
        MSDA_BACKWARD_KERNEL(*ptrs, d_value.data_ptr(), d_locs.data_ptr(),
                             d_aw.data_ptr(), *ints)
    else:
        sums = torch.zeros(value.shape, dtype=torch.float32,
                           device=value.device)
        d_value = torch.empty_like(value)
        MSDA_BACKWARD_BF16_KERNEL(*ptrs, sums.data_ptr(), d_value.data_ptr(),
                                  d_locs.data_ptr(), d_aw.data_ptr(), *ints)
    return d_value, d_locs, d_aw


class MSDAFunction(torch.autograd.Function):
    """MSDA on CUDA tensors with a gradient: K3 forward, K4 backward.

    It takes its inputs as they come, also under ``torch.autocast``: the
    value keeps its dtype (the output and ``d_value`` have it), the
    locations and weights must be float32, and autocast casts nothing
    here (the port's bf16 policy uses no autocast; a caller that does
    gets the same kernels on the same dtypes)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type='cuda')
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msda_cuda(value, spatial_shapes, sampling_locations,
                         attention_weights)

    @staticmethod
    @once_differentiable
    @torch.amp.custom_bwd(device_type='cuda')
    def backward(ctx, grad_out):
        value, locs, aw = ctx.saved_tensors
        d_value, d_locs, d_aw = msda_backward_cuda(
            value, ctx.spatial_shapes, locs, aw, grad_out.contiguous())
        return d_value, None, d_locs, d_aw
