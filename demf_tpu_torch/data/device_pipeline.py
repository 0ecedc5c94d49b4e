"""On-device preprocessing: the host reads files and decodes images, the
card does the rest (port of ``demf_tpu/data/device_pipeline.py``).

The host pipeline (``data/pipeline.py``) repeats the reference's numpy /
OpenCV transforms scene by scene; here the same math runs on a whole raw
batch on its device:

* **Resize as two batched matrix products.**  A keep-ratio bilinear
  resize is separable, ``out = R_h @ img @ R_w^T``, each row of the
  per-image interpolation matrices holding the two bilinear taps of one
  output row or column (OpenCV's half-pixel rule ``s = (i + 0.5) * src /
  dst - 0.5``), and ``RandomFlip`` after ``Resize`` is the mirrored output
  column, folded into ``R_w``.  Two ``torch.bmm`` calls do it in float32
  (TF32 must be off where the card would use it); a two-tap gather would
  read each source pixel twice from scattered addresses, where the
  products stream the image through the tensor cores' float32 path.  The
  canvas is static: ``Resize(img_scale=(L, S), keep_ratio) + Pad(32)``
  always lands in ``(ceil32(S), ceil32(L))``; rows and columns past an
  image's new size are exact zeros (the host pads after ``Normalize``).
* **Points.**  The height channel from the masked 0.0099 quantile of z
  (``np.percentile(z, 0.99)``, linear interpolation: the ``k`` smallest by
  ``torch.topk(largest=False)`` where the rank is small, else a sort),
  ``RandomFlip3D``, ``GlobalRotScaleTrans`` (``p' = p @ R``), and
  ``PointSample``: without replacement the first ``num_points`` of a
  stable argsort of uniform keys (padding keyed 2), with replacement
  ``floor(u * n)`` where a cloud has fewer points; where ``num_points`` is
  the cap every point is kept in its own order (the set the argsort would
  keep, as in the JAX package).

Raw batches hold uint8 images and float32 point pads (``LoadRaw`` +
``make_raw_collate``): about a quarter of the bytes of preprocessed
float32 canvases.  A pipeline with host-only transforms (``AutoAugment``,
``RandomCrop``: the 2D pretrain's) raises ``UnsupportedPipeline``.

``make_device_preprocess(spec)`` returns ``preprocess(raw, generator,
draws=None)``: the random draws come from the caller's
``torch.Generator`` (on the raw batch's device) in the order of
``DRAW_ORDER``, each only where the spec uses it, or from ``draws`` by
name (the tests pass the JAX package's draws: ``jax.random`` cannot be
reproduced).  No Pallas kernel stands behind this module in the JAX
package, so it is plain PyTorch on whatever device the batch is on.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


class UnsupportedPipeline(ValueError):
    """Raised when a pipeline cfg contains host-only transforms."""


_DEVICE_TYPES = {
    'LoadPointsFromFile', 'LoadImageFromFile', 'LoadAnnotations3D',
    'LoadAnnotations', 'Resize', 'RandomFlip', 'Normalize', 'Pad',
    'RandomFlip3D', 'GlobalRotScaleTrans', 'PointSample',
    'DefaultFormatBundle3D', 'DefaultFormatBundle', 'Collect3D', 'Collect',
}

# the draws of a preprocess call, in the order a generator makes them:
# flip2d (B,) bool, flip3d (B,) bool, angle (B,), scale (B,), trans (B, 3),
# keys (B, points cap) and with_replacement (B, num_points) uniforms
DRAW_ORDER = ('flip2d', 'flip3d', 'angle', 'scale', 'trans', 'keys',
              'with_replacement')


def _ceil_to(v, m):
    return -(-int(v) // m) * m


class DevicePreprocessSpec:
    """Parsed, static view of a declarative pipeline cfg."""

    def __init__(self, pipeline_cfg: List[dict], points_cap: int = 65536,
                 raw_img_hw: Tuple[int, int] = (576, 768)):
        self.points_cap = int(points_cap)
        self.raw_img_hw = tuple(int(v) for v in raw_img_hw)
        self.has_img = False
        self.has_points = False
        self.load_dim = 6
        self.use_dim = [0, 1, 2]
        self.shift_height = False
        self.img_scale = None          # (long, short)
        self.flip2d_ratio = 0.0
        self.norm_mean = None
        self.norm_std = None
        self.norm_to_rgb = True
        self.pad_divisor = 32
        self.flip3d_ratio = 0.0
        self.rot_range = None
        self.scale_range = None
        self.trans_std = (0.0, 0.0, 0.0)
        self.grst_shift_height = False
        self.num_points = None
        self.collect_keys: List[str] = []
        self.with_bbox2d = False

        for t in self._flatten(pipeline_cfg):
            kind = t['type']
            if kind not in _DEVICE_TYPES:
                raise UnsupportedPipeline(
                    f'{kind} has no device formulation (host-only pipeline)')
            if kind == 'LoadPointsFromFile':
                self.has_points = True
                self.load_dim = t.get('load_dim', 6)
                self.use_dim = list(t.get('use_dim', [0, 1, 2]))
                self.shift_height = t.get('shift_height', False)
            elif kind == 'LoadImageFromFile':
                self.has_img = True
            elif kind == 'LoadAnnotations':
                self.with_bbox2d = t.get('with_bbox', True)
            elif kind == 'Resize':
                sc = t.get('img_scale')
                if sc is None or not t.get('keep_ratio', True):
                    raise UnsupportedPipeline(
                        'device Resize supports fixed keep_ratio img_scale')
                self.img_scale = (max(sc), min(sc))
            elif kind == 'RandomFlip':
                self.flip2d_ratio = float(t.get('flip_ratio') or 0.0)
            elif kind == 'Normalize':
                self.norm_mean = np.asarray(t['mean'], np.float32)
                self.norm_std = np.asarray(t['std'], np.float32)
                self.norm_to_rgb = t.get('to_rgb', True)
            elif kind == 'Pad':
                self.pad_divisor = t.get('size_divisor', 32) or 32
            elif kind == 'RandomFlip3D':
                self.flip3d_ratio = float(
                    t.get('flip_ratio_bev_horizontal') or 0.0)
            elif kind == 'GlobalRotScaleTrans':
                self.rot_range = tuple(t.get('rot_range',
                                             (-0.523599, 0.523599)))
                self.scale_range = tuple(t.get('scale_ratio_range',
                                               (0.85, 1.15)))
                self.trans_std = tuple(t.get('translation_std', (0, 0, 0)))
                self.grst_shift_height = t.get('shift_height', False)
            elif kind == 'PointSample':
                self.num_points = int(t['num_points'])
            elif kind in ('Collect3D', 'Collect'):
                self.collect_keys = list(t['keys'])
        if self.has_img and self.img_scale is None:
            raise UnsupportedPipeline('image pipeline without Resize')

    @staticmethod
    def _flatten(cfgs):
        out = []
        for t in cfgs:
            t = dict(t)
            kind = t.get('type')
            if kind in ('MultiScaleFlipAug3D', 'MultiScaleFlipAug'):
                inner = DevicePreprocessSpec._flatten(t['transforms'])
                if t.get('img_scale') is not None:
                    for it in inner:
                        if it['type'] == 'Resize':
                            it.setdefault('img_scale', t['img_scale'])
                out.extend(inner)
            else:
                out.append(t)
        return out

    @property
    def canvas_hw(self):
        long_e, short_e = self.img_scale
        return (_ceil_to(short_e, self.pad_divisor),
                _ceil_to(long_e, self.pad_divisor))

    @property
    def point_feat_dim(self):
        return len(self.use_dim) + (1 if self.shift_height else 0)


# ---------------------------------------------------------------------------
# host side: raw loading and the fixed-shape collate
# ---------------------------------------------------------------------------

class LoadRaw:
    """Minimal host transform: file bytes -> raw arrays, nothing else."""

    def __init__(self, spec: DevicePreprocessSpec):
        self.spec = spec

    def __call__(self, results):
        spec = self.spec
        if spec.has_points:
            pts = results.get('raw_points')
            if pts is None:
                pts = np.fromfile(results['pts_filename'],
                                  dtype=np.float32).reshape(
                                      -1, spec.load_dim)
            # a cloud past points_cap loses its tail before the device
            # subsample: raise points_cap for such data
            results['raw_points_sel'] = pts[:spec.points_cap,
                                            spec.use_dim].astype(np.float32)
        if spec.has_img:
            img = results.get('raw_img')
            if img is None:
                import cv2
                img = cv2.imread(results['img_filename'])  # BGR uint8
            results['raw_img_u8'] = np.ascontiguousarray(img, np.uint8)
        if 'ann_info' in results:
            ann = results['ann_info']
            results['gt_bboxes_3d'] = np.asarray(
                ann.get('gt_bboxes_3d', np.zeros((0, 7))),
                np.float32).reshape(-1, 7)
            results['gt_labels_3d'] = np.asarray(
                ann.get('gt_labels_3d', np.zeros((0,))), np.int32).reshape(-1)
            if spec.with_bbox2d:
                results['gt_bboxes'] = np.asarray(
                    ann.get('bboxes', np.zeros((0, 4))),
                    np.float32).reshape(-1, 4)
                results['gt_labels'] = np.asarray(
                    ann.get('labels', np.zeros((0,))), np.int32).reshape(-1)
        return results


def _pad_gt(samples, key, label_key, width, max_gt):
    """The samples' ``key`` boxes and ``label_key`` labels in (B, max_gt)
    pads with a valid mask."""
    b = len(samples)
    boxes = np.zeros((b, max_gt, width), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, s in enumerate(samples):
        g = min(len(s[key]), max_gt)
        boxes[i, :g] = s[key][:g]
        labels[i, :g] = s[label_key][:g]
        valid[i, :g] = True
    return boxes, labels, valid


def make_raw_collate(spec: DevicePreprocessSpec, max_gt: int = 64):
    """Fixed-shape raw collate: uint8 image pads and float32 point pads,
    with the keys of the JAX package's."""
    hc, wc = spec.raw_img_hw

    def collate_raw(samples):
        b = len(samples)
        batch: Dict[str, Any] = {}
        if spec.has_points:
            pts = np.zeros((b, spec.points_cap, len(spec.use_dim)),
                           np.float32)
            cnt = np.zeros((b,), np.int32)
            for i, s in enumerate(samples):
                p = s['raw_points_sel']
                n = min(len(p), spec.points_cap)
                pts[i, :n] = p[:n]
                cnt[i] = n
            batch['raw_points'] = pts
            batch['raw_points_count'] = cnt
        if spec.has_img:
            imgs = np.zeros((b, hc, wc, 3), np.uint8)
            shapes = np.zeros((b, 2), np.int32)
            for i, s in enumerate(samples):
                im = s['raw_img_u8']
                h, w = im.shape[:2]
                if h > hc or w > wc:
                    raise ValueError(
                        f'raw image {h}x{w} exceeds raw_img_hw cap '
                        f'{hc}x{wc}; raise DevicePreprocessSpec.raw_img_hw')
                if h > w:
                    raise ValueError('portrait raw image: device resize '
                                     'canvas assumes landscape inputs')
                imgs[i, :h, :w] = im
                shapes[i] = (h, w)
            batch['raw_img'] = imgs
            batch['raw_img_shape'] = shapes
        if 'gt_bboxes_3d' in samples[0]:
            (batch['gt_bboxes_3d'], batch['gt_labels_3d'],
             batch['gt_valid']) = _pad_gt(samples, 'gt_bboxes_3d',
                                          'gt_labels_3d', 7, max_gt)
        if spec.with_bbox2d and 'gt_bboxes' in samples[0]:
            (batch['gt_bboxes'], batch['gt_labels'],
             batch['gt_bboxes_valid']) = _pad_gt(samples, 'gt_bboxes',
                                                 'gt_labels', 4, max_gt)
        meta = {}
        if 'depth2img' in samples[0]:
            meta['depth2img'] = np.stack(
                [np.asarray(s['depth2img'], np.float32) for s in samples])
        batch['img_meta'] = meta
        batch['sample_idx'] = np.asarray(
            [s.get('sample_idx', -1) for s in samples], np.int32)
        return batch

    return collate_raw


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def _resize_matrix(n_src_cap, n_dst_cap, src_n, dst_n, flip=None):
    """Per-image separable bilinear interpolation matrix -> (B, n_dst_cap,
    n_src_cap) float32: row i the two taps of output index i (OpenCV's
    half-pixel rule), rows at or past ``dst_n`` zero; ``flip`` (B,) bool
    mirrors the output index (``RandomFlip`` after ``Resize``)."""
    dev = src_n.device
    i = torch.arange(n_dst_cap, dtype=torch.float32, device=dev)[None]
    srcf = src_n.float()[:, None]
    dstf = dst_n.float()[:, None]
    if flip is not None:
        i = torch.where(flip[:, None], dstf - 1.0 - i, i)
    s = (i + 0.5) * (srcf / dstf) - 0.5
    s = torch.minimum(s.clamp_min(0.0), srcf - 1.0)
    s0 = torch.floor(s)
    f = (s - s0)[..., None]
    j = torch.arange(n_src_cap, dtype=torch.float32, device=dev)[None, None]
    s0 = s0[..., None]
    mat = (1.0 - f) * (j == s0) + f * (j == s0 + 1.0)
    valid = torch.arange(n_dst_cap, device=dev)[None] < dst_n[:, None]
    return mat * valid[..., None]


def _masked_quantile_z(z, cnt, q):
    """``np.percentile(z[:n], q * 100)`` with linear interpolation, a row
    each: z (B, N) with padding after ``cnt``.  The rank needed is at most
    ``q (N - 1) + 1``, so where that is at most 1024 the k smallest
    (``torch.topk(largest=False)``, ascending) stand in for a sort."""
    n = z.shape[1]
    dev = z.device
    mask = torch.arange(n, device=dev)[None] < cnt[:, None]
    zm = torch.where(mask, z, torch.full_like(z, 3.4e38))
    k_cap = int(np.floor(q * (n - 1))) + 2
    if k_cap <= 1024:
        zs = torch.topk(zm, min(k_cap, n), dim=1, largest=False,
                        sorted=True).values
        n_idx = zs.shape[1]
    else:
        zs = torch.sort(zm, dim=1).values
        n_idx = n
    pos = q * (cnt.float() - 1.0)
    lo = torch.floor(pos).long().clamp(0, n_idx - 1)
    hi = torch.minimum((lo + 1).clamp(0, n_idx - 1),
                       (cnt.long() - 1).clamp_min(0))
    frac = pos - lo.float()
    vlo = torch.gather(zs, 1, lo[:, None])[:, 0]
    vhi = torch.gather(zs, 1, hi[:, None])[:, 0]
    return vlo * (1.0 - frac) + vhi * frac


def _bmm(a, b):
    """A batched matrix product in float32; TF32 would round its inputs
    to 10 bits of mantissa, so a card that would use it is refused."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError('the device resize needs float32 matrix products:'
                           ' set torch.backends.cuda.matmul.allow_tf32 = '
                           'False')
    return torch.bmm(a, b)


def make_device_preprocess(spec: DevicePreprocessSpec):
    """-> ``preprocess(raw, generator, draws=None)``: a collated raw batch
    (tensors on one device; ``raw_*`` keys and the rest) -> the model's
    batch on that device, without gradients."""
    long_e, short_e = spec.img_scale if spec.img_scale else (0, 0)
    canvas_h, canvas_w = spec.canvas_hw if spec.has_img else (0, 0)

    def drawn(draws, name, generator, make):
        if name in draws:
            return draws[name]
        if generator is None:
            raise ValueError(f'preprocess: no generator for the {name} draw')
        return make()

    @torch.no_grad()
    def preprocess(raw, generator, draws=None):
        draws = dict(draws or {})
        batch = {k: v for k, v in raw.items() if not k.startswith('raw_')}
        meta = dict(batch.get('img_meta', {}))
        dev = next(v.device for v in raw.values() if torch.is_tensor(v))

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        # -- the image ------------------------------------------------
        if spec.has_img and 'raw_img' in raw:
            img = raw['raw_img']
            shp = raw['raw_img_shape']
            b, hc, wc = img.shape[:3]
            h = shp[:, 0].float()
            w = shp[:, 1].float()
            factor = torch.minimum(long_e / torch.maximum(h, w),
                                   short_e / torch.minimum(h, w))
            new_h = torch.floor(h * factor + 0.5).int()
            new_w = torch.floor(w * factor + 0.5).int()
            if spec.flip2d_ratio > 0:
                flip2d = drawn(draws, 'flip2d', generator,
                               lambda: rand(b) < spec.flip2d_ratio)
            else:
                flip2d = torch.zeros((b,), dtype=torch.bool, device=dev)
            rh = _resize_matrix(hc, canvas_h, shp[:, 0], new_h)
            rw = _resize_matrix(wc, canvas_w, shp[:, 1], new_w, flip=flip2d)
            # rows: (B, Ho, Hc) @ (B, Hc, Wc * 3) -> (B, Ho, Wc, 3)
            t = _bmm(rh, img.float().reshape(b, hc, wc * 3))
            t = t.reshape(b, canvas_h, wc, 3)
            # columns: (B, Ho * 3, Wc) @ (B, Wc, Wo) -> (B, Ho, Wo, 3)
            t = _bmm(t.transpose(2, 3).reshape(b, canvas_h * 3, wc),
                     rw.transpose(1, 2))
            t = t.reshape(b, canvas_h, 3, canvas_w).transpose(2, 3)
            if spec.norm_to_rgb:
                t = t.flip(-1)
            if spec.norm_mean is not None:
                t = (t - torch.from_numpy(spec.norm_mean).to(dev)) / \
                    torch.from_numpy(spec.norm_std).to(dev)
            ys = torch.arange(canvas_h, device=dev)[None, :, None]
            xs = torch.arange(canvas_w, device=dev)[None, None, :]
            valid = (ys < new_h[:, None, None]) & (xs < new_w[:, None, None])
            # dense NHWC, as the host pipeline's images: the image branch
            # keeps its input's layout, and K11 reads its levels dense
            batch['img'] = torch.where(valid[..., None], t, torch.zeros(
                (), device=dev)).contiguous()
            w_scale = new_w.float() / w
            h_scale = new_h.float() / h
            meta['img_shape'] = torch.stack([new_h, new_w], 1)
            meta['scale_factor'] = torch.stack([w_scale, h_scale], 1)
            meta['flip'] = flip2d
            if 'gt_bboxes' in batch:
                sf = torch.stack([w_scale, h_scale, w_scale, h_scale], 1)
                bx = batch['gt_bboxes'] * sf[:, None, :]
                if spec.flip2d_ratio > 0:
                    wnf = new_w.float()[:, None, None]
                    flipped = torch.cat(
                        [wnf - bx[..., 2:3], bx[..., 1:2],
                         wnf - bx[..., 0:1], bx[..., 3:4]], -1)
                    bx = torch.where(flip2d[:, None, None], flipped, bx)
                batch['gt_bboxes'] = bx

        # -- the points -----------------------------------------------
        if spec.has_points and 'raw_points' in raw:
            pts = raw['raw_points']
            cnt = raw['raw_points_count']
            b, ncap = pts.shape[:2]
            if spec.shift_height:
                # np.percentile(z, 0.99) on the host: q in percent, so the
                # 0.0099 quantile (a robust floor height)
                floor_z = _masked_quantile_z(pts[..., 2], cnt, 0.99 / 100.0)
                pts = torch.cat([pts, (pts[..., 2] - floor_z[:, None])[
                    ..., None]], -1)
            boxes = batch.get('gt_bboxes_3d')

            if spec.flip3d_ratio > 0:
                flip3 = drawn(draws, 'flip3d', generator,
                              lambda: rand(b) < spec.flip3d_ratio)
            else:
                flip3 = torch.zeros((b,), dtype=torch.bool, device=dev)
            sgn = torch.where(flip3, -1.0, 1.0)
            pts = pts.clone()
            pts[..., 0] *= sgn[:, None]
            if boxes is not None:
                boxes = boxes.clone()
                boxes[..., 0] *= sgn[:, None]
                boxes[..., 6] = torch.where(flip3[:, None],
                                            math.pi - boxes[..., 6],
                                            boxes[..., 6])
            meta['pcd_horizontal_flip'] = flip3

            if spec.rot_range is not None:
                lo, hi = spec.rot_range
                angle = drawn(draws, 'angle', generator,
                              lambda: lo + (hi - lo) * rand(b))
                lo, hi = spec.scale_range
                scale = drawn(draws, 'scale', generator,
                              lambda: lo + (hi - lo) * rand(b))
                tstd = torch.tensor(spec.trans_std, dtype=torch.float32,
                                    device=dev)
                if float(np.max(spec.trans_std)) > 0:
                    trans = drawn(draws, 'trans', generator,
                                  lambda: tstd * torch.randn(
                                      (b, 3), generator=generator,
                                      device=dev))
                else:
                    trans = torch.zeros((b, 3), device=dev)
                c, s = torch.cos(angle), torch.sin(angle)
                zeros, ones = torch.zeros_like(c), torch.ones_like(c)
                # p' = p @ mat (the host's rotation convention)
                mat = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros,
                                   ones], -1).reshape(b, 3, 3)
                xyz = torch.einsum('bnc,bcd->bnd', pts[..., :3], mat)
                pts[..., :3] = xyz * scale[:, None, None] + trans[:, None, :]
                if spec.grst_shift_height and pts.shape[-1] > 3:
                    pts[..., 3] *= scale[:, None]
                if boxes is not None:
                    ctr = torch.einsum('bnc,bcd->bnd', boxes[..., :3], mat)
                    boxes = torch.cat([
                        ctr * scale[:, None, None] + trans[:, None, :],
                        boxes[..., 3:6] * scale[:, None, None],
                        boxes[..., 6:7] + angle[:, None, None]], -1)
                meta['pcd_rotation'] = mat
                meta['pcd_scale_factor'] = scale
                meta['pcd_trans'] = trans

            if boxes is not None:
                batch['gt_bboxes_3d'] = boxes

            if spec.num_points is not None:
                num = spec.num_points
                if num == ncap:
                    # cnt >= num only where cnt == ncap: every point kept
                    # (the argsort's set, in another order), no sort
                    perm = torch.arange(num, device=dev)[None].expand(b, num)
                else:
                    keys = drawn(draws, 'keys', generator,
                                 lambda: rand(b, ncap))
                    keys = torch.where(
                        torch.arange(ncap, device=dev)[None] < cnt[:, None],
                        keys, torch.full_like(keys, 2.0))
                    perm = torch.argsort(keys, dim=1, stable=True)[:, :num]
                u = drawn(draws, 'with_replacement', generator,
                          lambda: rand(b, num))
                wr = torch.floor(u * cnt.clamp_min(1)[:, None].float()).long()
                idx = torch.where((cnt >= num)[:, None], perm, wr)
                pts = torch.gather(pts, 1, idx[..., None].expand(
                    -1, -1, pts.shape[-1]))
            batch['points'] = pts

        batch['img_meta'] = meta
        return batch

    return preprocess


def build_device_pipeline(pipeline_cfg, points_cap=65536,
                          raw_img_hw=(576, 768), max_gt=64):
    """-> (host_load, collate_fn, preprocess, spec); raises
    ``UnsupportedPipeline`` where the cfg needs host-only transforms."""
    spec = DevicePreprocessSpec(pipeline_cfg, points_cap=points_cap,
                                raw_img_hw=raw_img_hw)
    return (LoadRaw(spec), make_raw_collate(spec, max_gt=max_gt),
            make_device_preprocess(spec), spec)
