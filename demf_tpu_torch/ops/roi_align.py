"""RoIAlign over an FPN pyramid: CUDA kernel K11 and its plain version, and
the single-level form.

Port of ``demf_tpu/models/rpn_roi.py::pyramid_roi_align`` (vmapped over the
images by ``StandardRoIHead``) and ``demf_tpu/ops/roi_align.py::roi_align``.
The sample rule of both: ``aligned=True`` (coordinates shifted by -0.5), a
fixed ``samples_per_bin`` x ``samples_per_bin`` grid of samples a bin at the
sub-bin centres, bilinear interpolation between the four neighbouring
pixels with their indices clamped to the map (mmcv reads zero outside, the
JAX package clamps), and the mean of the samples.  Maps are NHWC; the
result is (R, out, out, C), channels last.

A CUDA tensor launches K11 (``csrc/roi_align.cu``): one launch for the
batch, the levels read in place, a block a RoI that first stages the RoI's
sample table (``sample_table``) in shared memory.  A CPU tensor takes the
plain version, which gathers the four corners of every sample from the
concatenated pyramid, a chunk of RoIs at a time.  Both round as the same
sequence of float32 operations, so their outputs are equal bit for bit.

The gradient with respect to the levels (the image-only Faster R-CNN trains
through it) is K12 on the card (``demf_roi_align_backward`` in the same
source: the levels cut into tiles, each tile's list of (RoI, bin) entries
walked in order by one block that writes every pixel of the tile once;
no atomics into the levels, no zero-fill, the same bits on every call,
equal to ``pyramid_roi_align_backward_tiles_plain``) and autograd of the
plain version on the CPU (``pyramid_roi_align_backward_plain``).  The
RoIs take no gradient in either package (proposals are stopped, GT boxes
are data): on the card a RoI tensor that requires one is refused.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_cuda

# 4 level pointers, rois, levels, out; B, R, C, L, out, samples; 4 heights,
# 4 widths; 4 scales
ROI_ALIGN_KERNEL = CudaKernel(
    'demf_roi_align', [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 +
    [ctypes.c_float] * 4)

# K12: 4 level-gradient pointers, rois, levels, d_out, 8 scratch pointers;
# B, R, C, L, out, samples, 4 heights, 4 widths; 4 scales; the chunk, the
# partial tiles
ROI_ALIGN_BACKWARD_KERNEL = CudaKernel(
    'demf_roi_align_backward', [ctypes.c_void_p] * 15 +
    [ctypes.c_int] * 14 + [ctypes.c_float] * 4 + [ctypes.c_int] * 2)

K11_MAX_LEVELS = 4
# K12's tile (rows, columns), the entries a chunk of a tile's list takes,
# and what its partial tiles may hold
K12_TILE = (8, 8)
K12_CHUNK = 256
K12_PARTIAL_BYTES = 64 << 20
# the plain version pools about this many output numbers at a time
PLAIN_CHUNK = 1 << 24


def _div(x, d):
    """``x / d`` rounded once: a tensor divisor, because PyTorch on the card
    divides by a Python number as a product with its rounded reciprocal
    (off by an ulp where ``d`` is not a power of two; K11 divides)."""
    return x / torch.full_like(x, d)


def _sample_corners(x1, y1, x2, y2, out, s):
    """Per-RoI sample coordinates along one axis each, as the JAX package
    computes them: (x0, wx, y0, wy), each (..., out * s), x0 / y0 floored,
    wx / wy the weight of the far corner."""
    gi = _div(torch.arange(out * s, device=x1.device, dtype=x1.dtype) + 0.5,
              s)
    bin_w = _div((x2 - x1).clamp_min(1e-3), out)
    bin_h = _div((y2 - y1).clamp_min(1e-3), out)
    sx = x1[..., None] + gi * bin_w[..., None] - 0.5
    sy = y1[..., None] + gi * bin_h[..., None] - 0.5
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    return x0, sx - x0, y0, sy - y0


def _bilinear_mean(gather, x0, wx, y0, wy, out, s):
    """The four corners' weighted sum of every sample, averaged over a
    bin's samples: summed in row-major sample order, then divided by their
    count (K11 repeats these roundings, so the two agree bit for bit);
    ``gather(yi, xi)`` reads (..., oy, ox, C) of the integer corner
    coordinates (..., oy) and (..., ox)."""
    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wy = wy[..., :, None, None]
    wx = wx[..., None, :, None]
    val = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
           v10 * wy * (1 - wx) + v11 * wy * wx)
    lead = val.shape[:-3]
    val = val.reshape(*lead, out, s, out, s, val.shape[-1])
    acc = val[..., :, 0, :, 0, :]
    for k in range(1, s * s):
        acc = acc + val[..., :, k // s, :, k % s, :]
    return _div(acc, s * s)


def roi_align(features, rois, output_size=7, spatial_scale=1.0,
              samples_per_bin=2):
    """One image's single map (H, W, C) and RoIs (R, 4) xyxy in input
    coordinates -> (R, out, out, C).  Plain PyTorch on any device (no path
    of the port calls it; the pyramid form shares its sample rule)."""
    h, w, c = features.shape
    out, s = output_size, samples_per_bin
    boxes = rois * spatial_scale
    x0, wx, y0, wy = _sample_corners(boxes[:, 0], boxes[:, 1], boxes[:, 2],
                                     boxes[:, 3], out, s)
    flat = features.reshape(h * w, c)

    def gather(yi, xi):
        yi = yi.long().clamp(0, h - 1)
        xi = xi.long().clamp(0, w - 1)
        return flat[yi[:, :, None] * w + xi[:, None, :]]

    return _bilinear_mean(gather, x0, wx, y0, wy, out, s)


def roi_levels(rois, num_levels):
    """mmdet's level of each RoI (..., 4):
    ``floor(log2(sqrt(max(w * h, 1e-6)) / 56 + 1e-6))`` clamped to
    [0, num_levels - 1], as int32."""
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    scale = torch.sqrt((w * h).clamp_min(1e-6))
    lvl = torch.floor(torch.log2(scale / 56.0 + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def pyramid_roi_align(feats, rois, lvl, strides, out_size=7,
                      samples_per_bin=2):
    """RoIAlign of each RoI on its assigned level.

    feats: tuple of (B, H_l, W_l, C) maps; rois (B, R, 4) xyxy in input
    coordinates; lvl (B, R) integer levels; strides: a stride a level ->
    (B, R, out, out, C).  A CPU tensor takes the plain version; a CUDA
    tensor launches K11 (float32 only), with K12 as its backward where a
    level takes a gradient, or raises; so do RoIs that require one.
    """
    if rois.device.type == 'cpu':
        return pyramid_roi_align_plain(feats, rois, lvl, strides, out_size,
                                       samples_per_bin)
    if rois.requires_grad:
        raise ValueError('pyramid_roi_align: the RoIs take no gradient '
                         '(detach them); K12 returns the levels\' only')
    return _PyramidRoIAlign.apply(rois, lvl, tuple(strides), out_size,
                                  samples_per_bin, *feats)


class _PyramidRoIAlign(torch.autograd.Function):
    """K11 forward, K12 backward (the levels' gradients only)."""

    @staticmethod
    def forward(ctx, rois, lvl, strides, out_size, samples, *feats):
        ctx.save_for_backward(rois, lvl)
        ctx.args = (tuple(f.shape for f in feats), strides, out_size,
                    samples)
        return pyramid_roi_align_cuda(feats, rois, lvl, strides, out_size,
                                      samples)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        rois, lvl = ctx.saved_tensors
        shapes, strides, out_size, samples = ctx.args
        d_feats = pyramid_roi_align_backward_cuda(
            d_out.contiguous(), shapes, rois, lvl, strides, out_size, samples)
        return (None,) * 5 + tuple(
            d if need else None
            for d, need in zip(d_feats, ctx.needs_input_grad[5:]))


def pyramid_roi_align_plain(feats, rois, lvl, strides, out_size=7,
                            samples_per_bin=2):
    """The JAX package's form: one gather of the four corners of every
    sample from the concatenated pyramid (B, sum H_l W_l, C), a chunk of
    RoIs at a time."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    out, s = out_size, samples_per_bin
    dev = rois.device
    hs = torch.tensor([f.shape[1] for f in feats], device=dev)
    ws = torch.tensor([f.shape[2] for f in feats], device=dev)
    starts = torch.cumsum(hs * ws, 0) - hs * ws
    flat = torch.cat([f.reshape(b, -1, c) for f in feats], 1)
    inv = torch.tensor([1.0 / st for st in strides], dtype=rois.dtype,
                       device=dev)
    lvl = lvl.long()
    chunk = max(1, PLAIN_CHUNK // max(1, b * (out * s) ** 2 * c))
    outs = []
    for lo in range(0, r, chunk):
        lv = lvl[:, lo:lo + chunk]
        boxes = rois[:, lo:lo + chunk] * inv[lv][..., None]
        h_l, w_l, start = hs[lv], ws[lv], starts[lv]
        x0, wx, y0, wy = _sample_corners(boxes[..., 0], boxes[..., 1],
                                         boxes[..., 2], boxes[..., 3], out, s)
        scene = torch.arange(b, device=dev)[:, None, None, None]

        def gather(yi, xi):
            yi = torch.minimum(yi.long().clamp_min(0), (h_l - 1)[..., None])
            xi = torch.minimum(xi.long().clamp_min(0), (w_l - 1)[..., None])
            idx = (start[..., None, None] + yi[..., :, None] *
                   w_l[..., None, None] + xi[..., None, :])
            return flat[scene, idx]

        outs.append(_bilinear_mean(gather, x0, wx, y0, wy, out, s))
    return torch.cat(outs, 1) if outs else flat.new_zeros(
        (b, 0, out, out, c))


def pyramid_roi_align_backward_plain(d_out, shapes, rois, lvl, strides,
                                     out_size=7, samples_per_bin=2):
    """The levels' gradients, autograd of the plain version: ``d_out``
    (B, R, out, out, C), the levels' ``shapes`` -> a (B, H_l, W_l, C)
    tensor a level.  The RoIAlign is linear in the levels, so zero levels
    stand in for them."""
    feats = tuple(torch.zeros(shape, dtype=d_out.dtype, device=d_out.device,
                              requires_grad=True) for shape in shapes)
    with torch.enable_grad():
        out = pyramid_roi_align_plain(feats, rois, lvl, strides, out_size,
                                      samples_per_bin)
    return torch.autograd.grad(out, feats, d_out, allow_unused=True,
                               materialize_grads=True)


def k12_tiles(shapes):
    """K12's tiles over levels of ``shapes`` (B, H, W, C): (tiles down,
    tiles across) a level, and an image's tiles."""
    th, tw = K12_TILE
    grid = [(-(-sh[1] // th), -(-sh[2] // tw)) for sh in shapes]
    return grid, sum(d * a for d, a in grid)


def k12_slots(b, r, shapes, c, out_size, chunk):
    """The partial tiles K12 keeps room for: what ``K12_PARTIAL_BYTES``
    holds, and no more than its lists could ask for (a list of n > chunk
    entries asks for fewer than 2 n / chunk; a RoI's bins reach at most
    every tile of its level)."""
    grid, _ = k12_tiles(shapes)
    down = max(d for d, _ in grid)
    across = max(a for _, a in grid)
    entries = b * r * out_size * out_size * down * across
    return min(K12_PARTIAL_BYTES // (K12_TILE[0] * K12_TILE[1] * c * 4),
               2 * -(-entries // chunk))


def k12_chunks(tile_n, chunk, slots):
    """K12's cut of each tile's list of ``tile_n`` entries (an int64
    tensor), as its plan kernel makes it: ceil(n / chunk) chunks, or
    where the lists of more than one chunk would take more than ``slots``
    partial tiles, each of those ``want * slots // demand`` (at least 1);
    -> (chunk length, chunks) a tile, balanced."""
    want = (tile_n + chunk - 1) // chunk
    demand = int(want[want > 1].sum())
    want = want.clamp_min(1)
    if demand > slots:
        want = torch.where(want > 1, (want * slots // demand).clamp_min(1),
                           want)
    one = torch.ones_like(tile_n)
    length = torch.where(tile_n > 0, (tile_n + want - 1) // want, one)
    return length, torch.where(tile_n > 0, (tile_n + length - 1) // length,
                               one)


def k12_lists(shapes, rois, lvl, strides, out_size=7, samples_per_bin=2):
    """K12's tile lists.  A RoI's entries in a tile are the bins whose
    corner rows meet the tile's rows times those whose corner columns meet
    its columns (a bin reaches pixels from its first sample's near corner
    to its last sample's far corner; both runs are of consecutive bins);
    a tile's list holds the entries of the image's RoIs on its level in
    RoI order, each RoI's row-major.  -> dict of the sample table
    (``sample_table``), each RoI's first bin and bins reaching each tile
    row (``oy``, ``ny``: (B, R, most tile rows)) and column (``ox``,
    ``nx``), where its entries start in each tile's list (``start``:
    (B, R, rows, columns) of its level) and the lists' lengths
    (``tile_n``, in the kernel's tile order: image, level, row,
    column)."""
    b, r = rois.shape[:2]
    out, s = out_size, samples_per_bin
    dev = rois.device
    th, tw = K12_TILE
    lvl = lvl.long().clamp(0, len(shapes) - 1)
    table = sample_table(rois, lvl, strides, [sh[1:3] for sh in shapes],
                         out, s)
    grid, _ = k12_tiles(shapes)

    def runs(near, far, size, count):
        lo = torch.arange(count, device=dev) * size
        first = (far.view(b, r, out, s)[..., -1][..., None, :] <
                 lo[:, None]).sum(-1)
        end = (near.view(b, r, out, s)[..., 0][..., None, :] <=
               (lo + size - 1)[:, None]).sum(-1)
        return first, (end - first).clamp_min(0)

    oy, ny = runs(*table['y'][:2], th, max(d for d, _ in grid))
    ox, nx = runs(*table['x'][:2], tw, max(a for _, a in grid))
    cnt = ny[..., :, None] * nx[..., None, :]
    start = torch.zeros_like(cnt)
    tile_n = []
    for level, (down, across) in enumerate(grid):
        on = (lvl == level)[..., None, None]
        mine = cnt * on
        ends = torch.cumsum(mine, 1)
        start = torch.where(on, ends - mine, start)
        tile_n.append(ends[:, -1, :down, :across].reshape(b, -1))
    return dict(table=table, oy=oy, ny=ny, ox=ox, nx=nx, start=start,
                tile_n=torch.cat(tile_n, 1).reshape(-1))


def _axis_weights(near, far, w_near, w_far, out, s):
    """A bin's weight on each pixel its corners reach on one axis: the
    corners in (sample, near / far) order, (..., out, 2 s) each; a corner
    is kept where it is the first of its pixel, with the weights of its
    pixel's corners summed in that order from zero.  -> (pixels, weights,
    kept)."""
    pix = torch.stack([near, far], -1).reshape(*near.shape[:-1], out, 2 * s)
    wts = torch.stack([w_near, w_far], -1).reshape(pix.shape)
    k = torch.arange(2 * s, device=pix.device)
    same = pix[..., :, None] == pix[..., None, :]
    first = torch.where(same, k, 2 * s).min(-1).values
    sums = torch.zeros_like(wts)
    for i in range(2 * s):
        sums = sums + torch.where(first[..., i:i + 1] == k, wts[..., i:i + 1],
                                  0.0)
    return pix, sums, first == k


def pyramid_roi_align_backward_tiles_plain(d_out, shapes, rois, lvl, strides,
                                           out_size=7, samples_per_bin=2,
                                           chunk=K12_CHUNK, slots=None):
    """The levels' gradients in K12's order.  A bin's weight on a pixel
    is separable, ``w_y(y) * w_x(x)``, each the sum of its samples' corner
    weights on that row or column (in sample then corner order, from
    zero), so each (RoI, bin) entry adds one term to each pixel its
    corners reach: ``(d_out * (w_y / (s * s))) * w_x``.  A pixel sums its
    terms in (RoI, bin) order.  A tile's list
    (``k12_lists``) is cut into chunks as ``k12_chunks`` cuts it; a pixel
    whose tile has more than one sums each chunk's terms apart and then
    the chunks' sums in order.  Those sums are taken one term a pixel a
    step (``index_add_``), from zero.  The kernel equals this bit for bit.
    ``slots`` defaults to ``k12_slots``."""
    b, r = rois.shape[:2]
    c = d_out.shape[-1]
    out, s = out_size, samples_per_bin
    dev = d_out.device
    if d_out.numel() == 0:
        return tuple(torch.zeros(sh, dtype=d_out.dtype, device=dev)
                     for sh in shapes)
    if slots is None:
        slots = k12_slots(b, r, shapes, c, out, chunk)
    th, tw = K12_TILE
    lvl = lvl.long().clamp(0, len(shapes) - 1)
    lists = k12_lists(shapes, rois, lvl, strides, out, s)
    (y0, y1, yfar, ynear), (x0, x1, xfar, xnear) = (lists['table']['y'],
                                                    lists['table']['x'])
    oy, nx, ox, start = lists['oy'], lists['nx'], lists['ox'], lists['start']
    grid, per_image = k12_tiles(shapes)
    length, _ = k12_chunks(lists['tile_n'], chunk, slots)

    # every term, in (image, RoI, bin row, bin column, row corner, column
    # corner) order, where both corners are the first of their pixel
    ys, wy, keep_y = _axis_weights(y0, y1, ynear, yfar, out, s)
    xs, wx, keep_x = _axis_weights(x0, x1, xnear, xfar, out, s)
    full = (b, r, out, out, 2 * s, 2 * s)
    keep = (keep_y[:, :, :, None, :, None] &
            keep_x[:, :, None, :, None, :]).expand(full).reshape(-1)
    wy = _div(wy, s * s)
    terms = ((d_out.view(b, r, out, out, 1, 1, c) *
              wy[:, :, :, None, :, None, None]) *
             wx[:, :, None, :, None, :, None]).reshape(-1, c)[keep]
    ys = ys[:, :, :, None, :, None].expand(full).reshape(-1)[keep]
    xs = xs[:, :, None, :, None, :].expand(full).reshape(-1)[keep]

    def each(t):
        return t.expand(full).reshape(-1)[keep]

    scene = each(torch.arange(b, device=dev).view(b, 1, 1, 1, 1, 1))
    roi = each(torch.arange(r, device=dev).view(1, r, 1, 1, 1, 1))
    bin_y = each(torch.arange(out, device=dev).view(1, 1, out, 1, 1, 1))
    bin_x = each(torch.arange(out, device=dev).view(1, 1, 1, out, 1, 1))
    level = each(lvl.view(b, r, 1, 1, 1, 1))
    ty, tx = ys // th, xs // tw
    rank = (start[scene, roi, ty, tx] + (bin_y - oy[scene, roi, ty]) *
            nx[scene, roi, tx] + bin_x - ox[scene, roi, tx])
    base = torch.tensor([0] + [d * a for d, a in grid[:-1]],
                        device=dev).cumsum(0)
    across = torch.tensor([a for _, a in grid], device=dev)
    chunk_of = rank // length[scene * per_image + base[level] +
                              ty * across[level] + tx]
    sizes = [b * sh[1] * sh[2] for sh in shapes]
    offset = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)
    hs = torch.tensor([sh[1] for sh in shapes], device=dev)
    ws = torch.tensor([sh[2] for sh in shapes], device=dev)
    pixel = offset[level] + (scene * hs[level] + ys) * ws[level] + xs
    chunks = int(chunk_of.max()) + 1
    key, order = torch.sort(pixel * chunks + chunk_of, stable=True)
    terms = terms[order]
    place = torch.arange(key.numel(), device=dev)
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    group = torch.cumsum(new, 0) - 1
    step = place - torch.cummax(torch.where(new, place, 0), 0).values
    step, by_step = torch.sort(step, stable=True)
    sums = torch.zeros((int(new.sum()), c), dtype=d_out.dtype, device=dev)
    at = 0
    for n in torch.bincount(step).tolist():
        pick = by_step[at:at + n]
        sums.index_add_(0, group[pick], terms[pick])
        at += n
    key = key[new]
    total = torch.zeros((sum(sizes), c), dtype=d_out.dtype, device=dev)
    for k in range(chunks):
        pick = key % chunks == k
        total.index_add_(0, key[pick] // chunks, sums[pick])
    return tuple(part.view(sh) for part, sh in zip(total.split(sizes),
                                                    shapes))


def sample_table(rois, lvl, strides, sizes, out_size=7,
                 samples_per_bin=2):
    """K11's per-RoI sample table, as the kernel stages it: for each RoI
    (..., 4) on its level ``lvl`` (...) of the ``strides`` and ``sizes``
    ((H, W) a level), each sample of each axis: the corner indices clamped
    to the level, the far corner's weight and the near one's.  -> dicts
    'y' and 'x' of (near index, far index, far weight, near weight), each
    (..., out * s).  The same roundings as ``_sample_corners`` and the
    plain version's gather: the float clamped to [-1, size - 1] before it
    becomes an integer."""
    dev = rois.device
    lvl = lvl.long()
    scale = torch.tensor([1.0 / st for st in strides], dtype=rois.dtype,
                         device=dev)[lvl]
    n = out_size * samples_per_bin
    g = _div(torch.arange(n, device=dev, dtype=rois.dtype) + 0.5,
             samples_per_bin)
    table = {}
    for axis, lo_i, hi_i, dim in (('y', 1, 3, 0), ('x', 0, 2, 1)):
        size = torch.tensor([hw[dim] for hw in sizes], device=dev)[lvl]
        lo = rois[..., lo_i] * scale
        hi = rois[..., hi_i] * scale
        bin_len = _div((hi - lo).clamp_min(1e-3), out_size)
        v = lo[..., None] + g * bin_len[..., None] - 0.5
        v0 = torch.floor(v)
        far = v - v0
        top = (size - 1)[..., None].to(v.dtype)

        def clamp(f):
            i = torch.minimum(f.clamp_min(-1.0), top).long()
            return torch.minimum(i.clamp_min(0), (size - 1)[..., None])

        table[axis] = (clamp(v0), clamp(v0 + 1), far, 1 - far)
    return table


def pyramid_roi_align_cuda(feats, rois, lvl, strides, out_size=7,
                           samples_per_bin=2):
    """Kernel K11 (csrc/roi_align.cu): up to 4 float32 NHWC levels with
    the same B and C (a multiple of 4), float32 RoIs, integer levels, all
    contiguous on the card; ``out_size`` at most 32 and ``out_size *
    samples_per_bin`` at most 1024.  A block owns a RoI over 128 channels,
    a warp a bin column, a thread 4 channels of it."""
    if not 1 <= len(feats) <= K11_MAX_LEVELS or len(strides) != len(feats):
        raise ValueError(f'K11 takes 1 to {K11_MAX_LEVELS} levels with a '
                         f'stride each, got {len(feats)} and {len(strides)}')
    check_cuda('rois', rois, torch.float32, 3)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    for i, f in enumerate(feats):
        check_cuda(f'feats[{i}]', f, torch.float32, 4)
        if f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f'feats[{i}] {tuple(f.shape)} does not go with '
                             f'rois {tuple(rois.shape)} and C {c}')
    if not (1 <= out_size <= 32 and samples_per_bin >= 1 and
            out_size * samples_per_bin <= 1024):
        raise ValueError(f'out_size {out_size}, samples_per_bin '
                         f'{samples_per_bin}: K11 takes out_size <= 32 and '
                         f'out_size * samples_per_bin <= 1024')
    if rois.shape[-1] != 4 or c % 4:
        raise ValueError(f'rois {tuple(rois.shape)} and C {c}: K11 takes '
                         f'(B, R, 4) xyxy and C a multiple of 4')
    if not lvl.is_cuda or lvl.shape != (b, r) or lvl.dtype.is_floating_point:
        raise ValueError(f'lvl must be (B, R) integers on the card, got '
                         f'{lvl.dtype} {tuple(lvl.shape)} on {lvl.device}')
    lvl = lvl.to(torch.int32).contiguous()
    out = torch.empty((b, r, out_size, out_size, c), dtype=torch.float32,
                      device=rois.device)
    if out.numel() == 0:
        return out
    levels = list(feats) + [feats[0]] * (K11_MAX_LEVELS - len(feats))
    inv = [1.0 / st for st in strides] + [1.0] * (K11_MAX_LEVELS -
                                                 len(strides))
    ROI_ALIGN_KERNEL(*(f.data_ptr() for f in levels), rois.data_ptr(),
                     lvl.data_ptr(), out.data_ptr(), b, r, c, len(feats),
                     out_size, samples_per_bin,
                     *(f.shape[1] for f in levels),
                     *(f.shape[2] for f in levels), *inv)
    return out


def pyramid_roi_align_backward_cuda(d_out, shapes, rois, lvl, strides,
                                    out_size=7, samples_per_bin=2,
                                    chunk=K12_CHUNK, slots=None):
    """Kernel K12 (csrc/roi_align.cu): the levels' gradients from ``d_out``
    (B, R, out, out, C) float32, as tensors of ``shapes`` that it writes in
    full, for K11's RoIs and levels and under its limits; four kernels a
    call.  ``chunk`` and ``slots`` as
    ``pyramid_roi_align_backward_tiles_plain`` takes them, whose result
    this equals bit for bit."""
    if not 1 <= len(shapes) <= K11_MAX_LEVELS or len(strides) != len(shapes):
        raise ValueError(f'K12 takes 1 to {K11_MAX_LEVELS} levels with a '
                         f'stride each, got {len(shapes)} and {len(strides)}')
    check_cuda('d_out', d_out, torch.float32, 5)
    check_cuda('rois', rois, torch.float32, 3)
    b, r = rois.shape[:2]
    c = shapes[0][-1]
    if tuple(d_out.shape) != (b, r, out_size, out_size, c):
        raise ValueError(f'd_out {tuple(d_out.shape)} does not go with rois '
                         f'{tuple(rois.shape)}, out_size {out_size}, C {c}')
    if any(len(s) != 4 or s[0] != b or s[-1] != c for s in shapes):
        raise ValueError(f'level shapes {[tuple(s) for s in shapes]} do not '
                         f'go with rois {tuple(rois.shape)} and C {c}')
    if not (1 <= out_size <= 32 and samples_per_bin >= 1 and
            out_size * samples_per_bin <= 1024) or c % 4:
        raise ValueError(f'out_size {out_size}, samples_per_bin '
                         f'{samples_per_bin}, C {c}: K12 takes K11\'s limits')
    if not lvl.is_cuda or lvl.shape != (b, r) or lvl.dtype.is_floating_point:
        raise ValueError(f'lvl must be (B, R) integers on the card, got '
                         f'{lvl.dtype} {tuple(lvl.shape)} on {lvl.device}')
    if chunk < 1:
        raise ValueError(f'chunk {chunk}: K12 takes a chunk of at least 1')
    dev = d_out.device
    if d_out.numel() == 0:
        return tuple(torch.zeros(s, dtype=torch.float32, device=dev)
                     for s in shapes)
    if slots is None:
        slots = k12_slots(b, r, shapes, c, out_size, chunk)
    lvl = lvl.to(torch.int32).contiguous()
    th, tw = K12_TILE
    tiles = b * k12_tiles(shapes)[1]
    # int32 scratch, each part 16-byte aligned: the sample tables, the
    # bins' first and last corners, the spans, the tiles' chunks, the
    # lists' lengths, the work items, the arrivals
    parts = [b * r * 2 * out_size * samples_per_bin * 4,
             b * r * 2 * out_size * 2, b * r * 4, tiles * 2, tiles,
             (tiles + slots) * 4, tiles * -(-c // 128)]
    parts = [-(-n // 4) * 4 for n in parts]
    ints = torch.empty(sum(parts), dtype=torch.int32, device=dev)
    partials = torch.empty(slots * th * tw * c, dtype=torch.float32,
                           device=dev)
    grads = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                  for s in shapes)
    levels = list(grads) + [grads[0]] * (K11_MAX_LEVELS - len(grads))
    inv = [1.0 / st for st in strides] + [1.0] * (K11_MAX_LEVELS -
                                                 len(strides))
    at, scratch = ints.data_ptr(), []
    for n in parts:
        scratch.append(at)
        at += 4 * n
    ROI_ALIGN_BACKWARD_KERNEL(
        *(g.data_ptr() for g in levels), rois.data_ptr(), lvl.data_ptr(),
        d_out.data_ptr(), *scratch, partials.data_ptr(), b, r, c, len(grads),
        out_size, samples_per_bin, *(g.shape[1] for g in levels),
        *(g.shape[2] for g in levels), *inv, chunk, slots)
    return grads
