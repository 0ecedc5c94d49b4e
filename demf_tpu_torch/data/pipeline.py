"""Data pipeline transforms (host numpy): the port's copy of
``demf_tpu/data/pipeline.py``, read from the same declarative pipelines
(configs/demf/demf_votenet.py, configs/_base_/datasets/
sunrgbd-3d-10class.py).

Each transform is a callable class registered under its ``type=`` string
and operates on a sample dict.  Random draws come from ``np.random``'s
global state in the original's order, so the same ``np.random.seed`` gives
the same sample in both packages.  3D augmentations record the
inverse-transform metadata (``pcd_rotation`` / ``pcd_scale_factor`` /
``pcd_trans`` / flips / ``transformation_3d_flow``) that the DeMF head's
3D->2D reference-point bridge consumes.

The original resizes and normalizes with OpenCV.  Here both are numpy, so
that the pipeline needs no OpenCV where the image is already decoded (the
synthetic datasets): ``resize_bilinear`` repeats ``cv2.resize(...,
INTER_LINEAR)`` (uint8: bit for bit; float32: within 0.02 of a grey level;
the configs resize uint8), ``Normalize``
is the float32 subtract and multiply.  Only decoding a jpg needs OpenCV
(``LoadImageFromFile``, imported when a file is read).
"""
from __future__ import annotations

import numpy as np

from ..registry import PIPELINES, build_from_cfg

# cv2's fixed-point bilinear weights: 11 bits
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src, dst):
    """cv2's source index and weight of each destination index along one
    axis (half-pixel centers): (lower tap before clipping, float32 weight
    of the upper tap)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int32)
    return lo, f - lo.astype(np.float32)


def resize_bilinear(img, size):
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` in numpy;
    ``size`` is (width, height).  uint8 (H, W, C) images follow cv2's
    fixed-point arithmetic (weights rounded to 11 bits, the horizontal pass
    kept in 32-bit integers, its rounding shifts in the vertical pass) and
    come out equal bit for bit; float32 images are blended in float32,
    rows first, and agree within 0.02 on the 0-255 scale."""
    new_w, new_h = size
    h, w = img.shape[:2]
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f'resize_bilinear takes uint8 or float32, got '
                        f'{img.dtype}')
    sx, fx = _linear_taps(w, new_w)
    # along x cv2 clamps the tap and drops the weight at the borders
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    sy, fy = _linear_taps(h, new_h)
    # along y it clamps the rows and keeps the weights
    sy0, sy1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    shape = (-1,) + (1,) * (img.ndim - 2)
    if img.dtype == np.float32:
        rows = (img[:, sx] * (np.float32(1) - fx).reshape(shape) +
                img[:, sx1] * fx.reshape(shape))
        wy = fy.reshape((-1, 1) + (1,) * (img.ndim - 2))
        return rows[sy0] * (np.float32(1) - wy) + rows[sy1] * wy
    ax0 = np.rint((np.float32(1) - fx) * _COEF_SCALE).astype(np.int32)
    ax1 = np.rint(fx * _COEF_SCALE).astype(np.int32)
    by0 = np.rint((np.float32(1) - fy) * _COEF_SCALE).astype(np.int32)
    by1 = np.rint(fy * _COEF_SCALE).astype(np.int32)
    src = img.astype(np.int32)
    rows = (src[:, sx] * ax0.reshape(shape) +
            src[:, sx1] * ax1.reshape(shape)) >> 4
    by0 = by0.reshape((-1, 1) + (1,) * (img.ndim - 2))
    by1 = by1.reshape(by0.shape)
    out = (((rows[sy0] * by0) >> 16) + ((rows[sy1] * by1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _rotz_matrix(angle):
    """p' = p @ M, CCW by angle (DepthInstance3DBoxes.rotate convention)."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32).T


@PIPELINES.register_module()
class LoadPointsFromFile:
    def __init__(self, coord_type='DEPTH', load_dim=6, use_dim=(0, 1, 2),
                 shift_height=False, file_client_args=None):
        self.coord_type = coord_type
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.shift_height = shift_height

    def __call__(self, results):
        pts = results.get('raw_points')
        if pts is None:
            path = results['pts_filename']
            pts = np.fromfile(path, dtype=np.float32).reshape(
                -1, self.load_dim)
        pts = pts[:, self.use_dim].astype(np.float32)
        if self.shift_height:
            floor = np.percentile(pts[:, 2], 0.99)
            height = (pts[:, 2] - floor)[:, None]
            pts = np.concatenate([pts, height], 1)
        results['points'] = pts
        return results


@PIPELINES.register_module()
class LoadImageFromFile:
    def __init__(self, to_float32=False, file_client_args=None):
        self.to_float32 = to_float32

    def __call__(self, results):
        img = results.get('raw_img')
        if img is None:
            try:
                import cv2
            except ImportError as e:
                raise ImportError(
                    f"decoding {results['img_filename']} needs OpenCV "
                    f"(cv2), which is not installed; samples that carry "
                    f"'raw_img' (the synthetic datasets) need none") from e
            img = cv2.imread(results['img_filename'])  # BGR, uint8
        if self.to_float32:
            img = img.astype(np.float32)
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results


@PIPELINES.register_module()
class LoadAnnotations3D:
    def __init__(self, **kwargs):
        pass

    def __call__(self, results):
        ann = results['ann_info']
        results['gt_bboxes_3d'] = np.asarray(
            ann['gt_bboxes_3d'], np.float32).reshape(-1, 7)
        results['gt_labels_3d'] = np.asarray(
            ann['gt_labels_3d'], np.int32).reshape(-1)
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    def __init__(self, with_bbox=True, **kwargs):
        self.with_bbox = with_bbox

    def __call__(self, results):
        ann = results.get('ann_info', {})
        if self.with_bbox:
            results['gt_bboxes'] = np.asarray(
                ann.get('bboxes', np.zeros((0, 4))), np.float32).reshape(-1, 4)
            results['gt_labels'] = np.asarray(
                ann.get('labels', np.zeros((0,))), np.int32).reshape(-1)
        return results


@PIPELINES.register_module()
class Resize:
    """Resize keeping aspect ratio to fit within img_scale (mmdet policy)."""

    def __init__(self, img_scale=None, keep_ratio=True,
                 multiscale_mode='range', override=False, **kwargs):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio
        self.multiscale_mode = multiscale_mode
        self.override = override

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        scale = self.img_scale if (self.img_scale is not None and
                                   (self.override or
                                    'scale' not in results)) else \
            results.get('scale', self.img_scale)
        if isinstance(scale, list):  # multiscale_mode='value'
            scale = scale[np.random.randint(len(scale))]
        if self.keep_ratio:
            long_edge, short_edge = max(scale), min(scale)
            factor = min(long_edge / max(h, w), short_edge / min(h, w))
            new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
        else:
            new_w, new_h = scale
        resized = resize_bilinear(img, (new_w, new_h))
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = resized
        results['img_shape'] = resized.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if 'gt_bboxes' in results and len(results['gt_bboxes']):
            results['gt_bboxes'] = (
                results['gt_bboxes'] * results['scale_factor'])
        return results


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, flip_ratio=0.0, **kwargs):
        self.flip_ratio = flip_ratio or 0.0

    def __call__(self, results):
        flip = bool(np.random.rand() < self.flip_ratio)
        results['flip'] = flip
        results['flip_direction'] = 'horizontal'
        if flip:
            results['img'] = results['img'][:, ::-1]
            if 'gt_bboxes' in results and len(results['gt_bboxes']):
                w = results['img_shape'][1]
                b = results['gt_bboxes'].copy()
                b[:, [0, 2]] = w - results['gt_bboxes'][:, [2, 0]]
                results['gt_bboxes'] = b
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        # mmcv imnormalize_ in numpy: BGR -> RGB, then (img - mean) / std as
        # a float32 subtract and a multiply by the float32 reciprocal
        img = results['img']
        if self.to_rgb:
            img = img[..., ::-1]
        img = np.array(img, dtype=np.float32, order='C')
        img -= self.mean
        img *= np.float32(1.0) / self.std
        results['img'] = img
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size=None, size_divisor=None, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        if self.size_divisor:
            ph = -(-h // self.size_divisor) * self.size_divisor
            pw = -(-w // self.size_divisor) * self.size_divisor
        else:
            ph, pw = self.size
        padded = np.full((ph, pw) + img.shape[2:], self.pad_val, img.dtype)
        padded[:h, :w] = img
        results['img'] = padded
        results['pad_shape'] = padded.shape
        return results


@PIPELINES.register_module()
class RandomFlip3D:
    """BEV-horizontal flip of points + boxes (Depth coords: negate x)."""

    def __init__(self, sync_2d=False, flip_ratio_bev_horizontal=0.0,
                 **kwargs):
        self.sync_2d = sync_2d
        self.flip_ratio = flip_ratio_bev_horizontal

    def __call__(self, results):
        flip = bool(np.random.rand() < self.flip_ratio)
        results['pcd_horizontal_flip'] = flip
        results['pcd_vertical_flip'] = False
        results.setdefault('transformation_3d_flow', []).append('HF')
        if flip:
            results['points'][:, 0] = -results['points'][:, 0]
            if 'gt_bboxes_3d' in results and len(results['gt_bboxes_3d']):
                b = results['gt_bboxes_3d']
                b[:, 0] = -b[:, 0]
                b[:, 6] = np.pi - b[:, 6]
        return results


@PIPELINES.register_module()
class GlobalRotScaleTrans:
    def __init__(self, rot_range=(-0.523599, 0.523599),
                 scale_ratio_range=(0.85, 1.15), translation_std=(0, 0, 0),
                 shift_height=False):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float32)
        self.shift_height = shift_height

    def __call__(self, results):
        angle = np.random.uniform(*self.rot_range)
        scale = np.random.uniform(*self.scale_ratio_range)
        trans = (np.random.normal(scale=self.translation_std, size=3)
                 .astype(np.float32)
                 if np.any(self.translation_std > 0) else
                 np.zeros(3, np.float32))
        mat = _rotz_matrix(angle)

        pts = results['points']
        pts[:, :3] = pts[:, :3] @ mat
        pts[:, :3] = pts[:, :3] * scale
        if self.shift_height and pts.shape[1] > 3:
            pts[:, 3] = pts[:, 3] * scale
        pts[:, :3] = pts[:, :3] + trans
        results['points'] = pts

        if 'gt_bboxes_3d' in results and len(results['gt_bboxes_3d']):
            b = results['gt_bboxes_3d']
            b[:, :3] = b[:, :3] @ mat
            b[:, 6] = b[:, 6] + angle
            b[:, :6] = b[:, :6] * scale
            b[:, :3] = b[:, :3] + trans

        results['pcd_rotation'] = mat
        results['pcd_scale_factor'] = float(scale)
        results['pcd_trans'] = trans
        results.setdefault('transformation_3d_flow', []).extend(
            ['R', 'S', 'T'])
        return results


@PIPELINES.register_module()
class PointSample:
    def __init__(self, num_points, **kwargs):
        self.num_points = num_points

    def __call__(self, results):
        pts = results['points']
        n = pts.shape[0]
        choice = np.random.choice(n, self.num_points, replace=n < self.num_points)
        results['points'] = pts[choice]
        return results


@PIPELINES.register_module()
class DefaultFormatBundle3D:
    def __init__(self, class_names=None, with_label=True):
        self.class_names = class_names
        self.with_label = with_label

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect3D:
    META_FIELDS = ('img_shape', 'pad_shape', 'scale_factor', 'flip',
                   'depth2img', 'pcd_rotation', 'pcd_scale_factor',
                   'pcd_trans', 'pcd_horizontal_flip', 'pcd_vertical_flip',
                   'transformation_3d_flow', 'ori_shape', 'sample_idx')

    def __init__(self, keys, meta_keys=None):
        self.keys = keys
        self.meta_keys = meta_keys or self.META_FIELDS

    def __call__(self, results):
        out = {k: results[k] for k in self.keys if k in results}
        out['img_meta'] = {k: results[k] for k in self.meta_keys
                           if k in results}
        return out


@PIPELINES.register_module()
class MultiScaleFlipAug3D:
    """Test-time wrapper; with flip=False and one scale it just runs the
    inner transforms once (the reference's standard test path)."""

    def __init__(self, transforms, img_scale=None, pts_scale_ratio=1,
                 flip=False, **kwargs):
        self.transforms = Compose(transforms)
        self.img_scale = img_scale

    def __call__(self, results):
        if self.img_scale is not None:
            results['scale'] = self.img_scale
        return self.transforms(results)


@PIPELINES.register_module()
class RandomCrop:
    """Random crop (absolute_range mode), mmdet-compatible surface."""

    def __init__(self, crop_size, crop_type='absolute_range',
                 allow_negative_crop=True, **kwargs):
        self.crop_size = crop_size
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        ch = np.random.randint(min(self.crop_size[0], h),
                               min(self.crop_size[1], h) + 1)
        cw = np.random.randint(min(self.crop_size[0], w),
                               min(self.crop_size[1], w) + 1)
        y0 = np.random.randint(0, h - ch + 1)
        x0 = np.random.randint(0, w - cw + 1)
        results['img'] = img[y0:y0 + ch, x0:x0 + cw]
        results['img_shape'] = results['img'].shape
        results['img_crop_offset'] = np.array([x0, y0], np.float32)
        if 'gt_bboxes' in results and len(results['gt_bboxes']):
            b = results['gt_bboxes'] - np.array([x0, y0, x0, y0], np.float32)
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, cw)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, ch)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            if not keep.any() and not self.allow_negative_crop:
                return results
            results['gt_bboxes'] = b[keep]
            results['gt_labels'] = results['gt_labels'][keep]
        return results


@PIPELINES.register_module()
class AutoAugment:
    """Randomly pick one policy (a transform list) per sample."""

    def __init__(self, policies):
        self.policies = [Compose(p) for p in policies]

    def __call__(self, results):
        policy = self.policies[np.random.randint(len(self.policies))]
        return policy(results)


@PIPELINES.register_module()
class DefaultFormatBundle:
    def __init__(self, **kwargs):
        pass

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class ImageToTensor:
    def __init__(self, keys=(), **kwargs):
        self.keys = keys

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect:
    def __init__(self, keys, meta_keys=None):
        self.keys = keys
        self.meta_keys = meta_keys or Collect3D.META_FIELDS

    def __call__(self, results):
        out = {k: results[k] for k in self.keys if k in results}
        out['img_meta'] = {k: results[k] for k in self.meta_keys
                           if k in results}
        return out


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """2D test-time wrapper (single scale, no flip -> run inner once)."""

    def __init__(self, transforms, img_scale=None, flip=False, **kwargs):
        self.transforms = Compose(transforms)
        self.img_scale = img_scale

    def __call__(self, results):
        if self.img_scale is not None:
            results['scale'] = self.img_scale
        return self.transforms(results)


class Compose:
    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if callable(t):
                self.transforms.append(t)
            else:
                self.transforms.append(build_from_cfg(t, PIPELINES))

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results
