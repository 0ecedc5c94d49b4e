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

K11_MAX_LEVELS = 4
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
    tensor launches K11 (float32 only) or raises.
    """
    if rois.device.type == 'cpu':
        return pyramid_roi_align_plain(feats, rois, lvl, strides, out_size,
                                       samples_per_bin)
    return pyramid_roi_align_cuda(feats, rois, lvl, strides, out_size,
                                  samples_per_bin)


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
