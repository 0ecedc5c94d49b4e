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
# K4 takes the route last: on its float32 lists route the blocks of a
# (scene, head) (``msda_lists_parts``), else 0
MSDA_BACKWARD_KERNEL = CudaKernel(
    'demf_msda_backward', [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11)
# the same kernels on a bfloat16 value; K4's takes a scratch buffer beside
# the bfloat16 d_value (with tiles d_value's float32 sums, which it rounds
# once; on the row-owner route the entry lists)
MSDA_BF16_KERNEL = CudaKernel(
    'demf_msda_forward_bf16', [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10)
MSDA_BACKWARD_BF16_KERNEL = CudaKernel(
    'demf_msda_backward_bf16', [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11)
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
# csrc/msda_backward.cu: the most points a level of a tile's queries; the
# row-owner route's bits of an entry's index in its key, its most entries
# of a (scene, head, level), its sort's warps and digits, and the shared
# memory a sort block (or, on a float32 value, a lists block) may take
MSDA_BACKWARD_MAX_TILE_POINTS = 4
MSDA_ROWS_ID_BITS = 15
MSDA_ROWS_MAX_ENTRIES = 22528
MSDA_ROWS_SORT_WARPS = 16
MSDA_ROWS_DIGITS = 256
MSDA_ROWS_SMEM_LIMIT = 232448 - 1024
# the float32 row-owner route (its lists route): the most rows of a block's
# slice of a level, and the block's warps
MSDA_LISTS_PART_ROWS = 2048
MSDA_LISTS_WARPS = 16

# (spatial shapes, q, heads, levels, points, head_dim, dtype) -> K4's route
# without tiles: (msda_rows_route, and in float32 msda_lists_parts), worked
# out once a shape and not at every call
_ROUTES = {}
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


def msda_row_entries(spatial_shapes, sampling_locations, attention_weights):
    """K4's entries on its row-owner route: every bilinear corner of every
    sample, (B, heads, E) token rows (``sum_HW`` where the corner is off
    the map, so that it adds nothing) and float32 weights ``a * (w_x *
    w_y)``, at index ``((level * Q + query) * P + point) * 4 + corner`` of
    E = L * Q * P * 4, the corner (dy, dx) being 2 * dy + dx."""
    b, q, heads, levels, points, _ = sampling_locations.shape
    s = sum(int(h) * int(w) for h, w in spatial_shapes)
    loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)
    at = attention_weights.float().permute(0, 2, 1, 3, 4)  # (B, h, Q, L, P)
    rows, weights = [], []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        lx, ly = x - x0, y - y0
        x0, y0 = x0.long(), y0.long()
        corner_rows, corner_weights = [], []
        for dy, wy in ((0, 1 - ly), (1, ly)):
            for dx, wx in ((0, 1 - lx), (1, lx)):
                xi, yi = x0 + dx, y0 + dy
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                corner_rows.append(torch.where(ok, start + yi * w + xi, s))
                corner_weights.append(torch.where(
                    ok, at[:, :, :, lvl] * (wx * wy), 0.0))
        rows.append(torch.stack(corner_rows, -1))        # (B, h, Q, P, 4)
        weights.append(torch.stack(corner_weights, -1))
        start += h * w
    return (torch.stack(rows, 2).reshape(b, heads, -1),
            torch.stack(weights, 2).reshape(b, heads, -1))


def msda_backward_rows_plain(value, spatial_shapes, sampling_locations,
                             attention_weights, grad_out):
    """d_value in K4's row-owner order: the entries of ``msda_row_entries``
    sorted by row, stably (so a row's stay in the order of their index),
    and each row summed in float32, ``weight * grad_out`` of the entry's
    query added one after another (``index_add_``, one entry a row a step),
    then rounded once to the value's dtype.  The kernel's route computes the
    same sums in the same order: its d_value equals this bit for bit."""
    b, s, heads, hd = value.shape
    q, points = sampling_locations.shape[1], sampling_locations.shape[4]
    rows, weights = msda_row_entries(spatial_shapes, sampling_locations,
                                     attention_weights)
    rows, order = torch.sort(rows, dim=-1, stable=True)
    weights = torch.gather(weights, -1, order)
    query = order % (q * points * 4) // (points * 4)
    e = rows.shape[-1]
    place = torch.arange(e, device=rows.device).expand_as(rows)
    new_row = torch.ones_like(rows, dtype=torch.bool)
    new_row[..., 1:] = rows[..., 1:] != rows[..., :-1]
    rank = place - torch.cummax(torch.where(new_row, place, 0), -1).values
    lists = (torch.arange(b * heads, device=rows.device).view(b, heads, 1) *
             (s + 1) + rows)
    g = grad_out.float().view(b, q, heads, hd).permute(0, 2, 1, 3)
    g = torch.gather(g, 2, query[..., None].expand(-1, -1, -1, hd))
    terms = (weights[..., None] * g).reshape(-1, hd)
    lists, rank = lists.reshape(-1), rank.reshape(-1)
    sums = torch.zeros(b * heads * (s + 1), hd, dtype=torch.float32,
                       device=value.device)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        at_k = rank == k
        sums.index_add_(0, lists[at_k], terms[at_k])
    d_value = sums.view(b, heads, s + 1, hd)[:, :, :s].permute(0, 2, 1, 3)
    return d_value.to(value.dtype).contiguous()


def msda_rows_route(spatial_shapes, q, heads, levels, points, head_dim,
                    dtype):
    """The most tokens of any level where K4 takes its row-owner route for
    queries that are not the tokens on a value of ``dtype``, else 0
    (csrc/msda_backward.cu refuses it then): at most
    ``MSDA_ROWS_MAX_ENTRIES`` corners a (scene, head, level) and levels
    that are the shapes'.  In bfloat16 8 channels a thread and a token
    row's threads in one block (a head_dim that is a multiple of 8, heads *
    head_dim up to 2,048), rows that fit the keys beside the index, and the
    sort (two key buffers, its warps' digit counts or the rows' first
    entries) in a block's shared memory.  In float32 4 channels a thread (a
    head_dim that is a multiple of 4), any heads, and a lists block's
    shared memory holding the head's grad_out rows, a slice's row counts,
    its warps' counts of each owner warp, and each kept entry's weight,
    row, query and two orders."""
    most = max(int(h) * int(w) for h, w in spatial_shapes)
    e = q * points * 4
    if dtype == torch.float32:
        part = MSDA_LISTS_PART_ROWS
        fits = (head_dim % 4 == 0 and
                4 * q * head_dim + 4 * (part + part // 32 + 1) +
                4 * MSDA_LISTS_WARPS * (MSDA_LISTS_WARPS + 1) + 12 * e <=
                MSDA_ROWS_SMEM_LIMIT)
    else:
        fits = (head_dim % 8 == 0 and heads * head_dim <= 2048 and
                most < (1 << (32 - MSDA_ROWS_ID_BITS)) - 1 and
                8 * e + max(4 * MSDA_ROWS_DIGITS * MSDA_ROWS_SORT_WARPS,
                            2 * (most + 1)) <= MSDA_ROWS_SMEM_LIMIT)
    fits = (fits and levels == len(spatial_shapes) and
            0 < e <= MSDA_ROWS_MAX_ENTRIES)
    return most if fits else 0


def msda_lists_parts(spatial_shapes):
    """The blocks of a (scene, head) on K4's float32 lists route: each
    level cut into ceil(rows / ``MSDA_LISTS_PART_ROWS``) slices of rows."""
    return sum(-(-int(h) * int(w) // MSDA_LISTS_PART_ROWS)
               for h, w in spatial_shapes)


def msda_rows_scratch_bytes(b, s, q, heads, levels, points, dtype):
    """The row-owner route's scratch on a value of ``dtype``.  In bfloat16:
    keys, weights and sorted (weight, query) pairs of every entry (16 bytes
    an entry) and each (scene, head)'s first entry of every row, a level's
    rows and one more (2 bytes each).  In float32 none: its lists stay in
    a block's shared memory."""
    if dtype == torch.float32:
        return 0
    return (16 * b * heads * levels * q * points * 4 +
            2 * b * heads * (s + levels))


def _route(spatial_shapes, q, heads, levels, points, head_dim, dtype):
    key = (tuple((int(h), int(w)) for h, w in spatial_shapes), q, heads,
           levels, points, head_dim, dtype)
    if key not in _ROUTES:
        rows = msda_rows_route(*key)
        _ROUTES[key] = (rows, msda_lists_parts(key[0])
                        if rows and dtype == torch.float32 else 0)
    return _ROUTES[key]


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
    the value's dtype.  Without tiles (the decoders' queries), where
    ``msda_rows_route`` allows, the kernel takes its row-owner route, which
    writes each row of d_value once from its sorted entry list, with no
    float atomic and no fill (in float32 one kernel, a block a slice of a
    level's rows, its lists in shared memory; in bfloat16 three, the lists
    in a scratch buffer): its d_value equals ``msda_backward_rows_plain``
    bit for bit, call after call.
    Elsewhere a float32 d_value is zeroed and summed into, and a bfloat16
    one summed in float32 in a buffer of the value's size and rounded once
    (its tiles need a head_dim that is a multiple of 8)."""
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
    rows, parts = (0, 0) if tiles else _route(
        spatial_shapes, q, heads, levels, points, hd, value.dtype)
    if value.dtype == torch.float32:
        d_value = torch.empty_like(value) if rows else torch.zeros_like(value)
        MSDA_BACKWARD_KERNEL(*ptrs, d_value.data_ptr(), d_locs.data_ptr(),
                             d_aw.data_ptr(), *ints, parts)
        return d_value, d_locs, d_aw
    if rows:
        scratch = torch.empty(msda_rows_scratch_bytes(
            b, s, q, heads, levels, points, value.dtype), dtype=torch.uint8,
            device=value.device)
    else:
        scratch = torch.zeros(value.shape, dtype=torch.float32,
                              device=value.device)
    d_value = torch.empty_like(value)
    MSDA_BACKWARD_BF16_KERNEL(*ptrs, scratch.data_ptr(), d_value.data_ptr(),
                              d_locs.data_ptr(), d_aw.data_ptr(), *ints, rows)
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
