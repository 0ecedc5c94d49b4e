"""RoIs for the pyramid RoIAlign (K11) and its backward (K12), made on the
card from a seed: the FPN's four pooled levels of a 608x832 image, and
RoIs spread as the RPN's proposals are, crowded as the R-CNN's sampler
hands them over, or piled onto one box.  ``chip_smoke.py`` and
``compare_kernels`` time K11 and K12 on them."""
from __future__ import annotations

import torch

from ..ops import roi_align

ROI_LEVELS = ((152, 208), (76, 104), (38, 52), (19, 26))
ROI_STRIDES = (4, 8, 16, 32)
# what the R-CNN's sampler takes an image (configs/_base_/models/
# imvotenet_image.py:72-73: 512 RoIs, pos_fraction 0.25, the GT boxes
# added as proposals) and the GT boxes of a crowded scene
SAMPLED_ROIS = 512
CROWD_GTS = 16
ROI_KINDS = ('spread', 'crowded', 'piled')


def roi_case(dev, b, r=1000, c=256, seed=0):
    """``ROI_LEVELS`` maps of ``c`` channels and ``r`` RoIs a scene the size
    of the RPN's proposals (16 to 600 pixels, some across the borders),
    with mmdet's levels."""
    gen = torch.Generator(dev).manual_seed(seed)
    feats = tuple(torch.randn((b, h, w, c), generator=gen, device=dev)
                  for h, w in ROI_LEVELS)
    xy = torch.rand((b, r, 2), generator=gen, device=dev) * torch.tensor(
        [852.0, 628.0], device=dev) - 20
    wh = torch.exp(torch.rand((b, r, 2), generator=gen, device=dev) * 3.6 +
                   2.8)
    rois = torch.cat([xy, xy + wh], -1)
    return feats, rois, roi_align.roi_levels(rois, len(ROI_LEVELS))


def _iou(a, b):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = (a[..., 2:] - a[..., :2]).prod(-1) + (b[..., 2:] -
                                                 b[..., :2]).prod(-1)
    return inter / (area - inter)


def crowded_rois(dev, b, r=SAMPLED_ROIS, gts=CROWD_GTS, seed=0):
    """RoIs as the R-CNN's sampler hands them over in a scene of ``gts``
    objects: a quarter of them positives first (the GT boxes, 30 to 300
    pixels, then jitters of them: centres moved by up to a tenth of the
    box, sides scaled by up to 15%, each at IoU >= 0.5 with its box, or the
    box itself where a jitter falls below), the rest spread as
    ``roi_case``'s.  -> (rois (B, R, 4), levels)."""
    gen = torch.Generator(dev).manual_seed(seed)
    image = torch.tensor([832.0, 608.0], device=dev)
    wh = torch.exp(torch.rand((b, gts, 2), generator=gen, device=dev) * 2.3 +
                   3.4)
    xy = torch.rand((b, gts, 2), generator=gen, device=dev) * (image - wh)
    gt = torch.cat([xy, xy + wh], -1)
    pos = r // 4
    of = gt[:, torch.arange(pos - gts, device=dev) % gts]
    size = of[..., 2:] - of[..., :2]
    centre = (of[..., :2] + of[..., 2:]) / 2 + (torch.rand(
        of[..., :2].shape, generator=gen, device=dev) * 0.2 - 0.1) * size
    size = size * torch.exp(torch.rand(size.shape, generator=gen,
                                       device=dev) * 0.3 - 0.15)
    jitter = torch.cat([centre - size / 2, centre + size / 2], -1)
    jitter = torch.where((_iou(jitter, of) >= 0.5)[..., None], jitter, of)
    xy = torch.rand((b, r - pos, 2), generator=gen, device=dev) * (
        image + 20) - 20
    wh = torch.exp(torch.rand((b, r - pos, 2), generator=gen, device=dev) *
                   3.6 + 2.8)
    rois = torch.cat([gt, jitter, torch.cat([xy, xy + wh], -1)], 1)
    return rois, roi_align.roi_levels(rois, len(ROI_LEVELS))


def piled_rois(dev, b, r=SAMPLED_ROIS, seed=0):
    """Every RoI within 3 pixels of one 64 x 64 box, as a blown-up model's
    proposals pile up.  -> (rois (B, R, 4), levels)."""
    gen = torch.Generator(dev).manual_seed(seed)
    box = torch.tensor([300.0, 250.0, 364.0, 314.0], device=dev)
    rois = box + torch.rand((b, r, 4), generator=gen, device=dev) * 6 - 3
    return rois, roi_align.roi_levels(rois, len(ROI_LEVELS))


def k12_case(dev, b, kind, r=SAMPLED_ROIS, c=256, seed=0):
    """K12's inputs at the image-only step's shape: ``d_out`` (B, R, 7, 7,
    C) from a generator of ``seed``, the levels' shapes, RoIs of ``kind``
    (one of ``ROI_KINDS``; spread ones are ``roi_case``'s of seed + 1) and
    their levels."""
    if kind == 'spread':
        feats, rois, lvl = roi_case(dev, b, r=r, c=c, seed=seed + 1)
        del feats
    elif kind == 'crowded':
        rois, lvl = crowded_rois(dev, b, r, seed=seed + 1)
    elif kind == 'piled':
        rois, lvl = piled_rois(dev, b, r, seed=seed + 1)
    else:
        raise ValueError(f'kind {kind!r} not in {ROI_KINDS}')
    shapes = [(b, h, w, c) for h, w in ROI_LEVELS]
    d_out = torch.randn((b, r, 7, 7, c), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    return d_out, shapes, rois, lvl
