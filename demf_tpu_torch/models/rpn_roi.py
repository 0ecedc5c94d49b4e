"""The Faster R-CNN image branch of the ImVoteNet baseline (port of
``demf_tpu/models/rpn_roi.py``): anchors, the delta coder, the RPN head
with its fixed-shape proposals, the RoI head (pyramid RoIAlign +
Shared2FC) with its per-class detections, and the training half: the RPN's
loss over every anchor, the R-CNN's RoI sampling and its loss.

Everything is fixed-shape, as in the JAX package: padded proposals and
detections with validity masks.  The 2D NMS is ``ops/nms2d.py`` (K10 on
the card), the RoIAlign ``ops/roi_align.py`` (K11).  Where the JAX package
takes a top-k (``jax.lax.top_k``, which puts the lower index first among
equal values), the port sorts stably (``topk_stable``): ``torch.topk`` does
not promise that order on the card, and the order of the 2D boxes decides
which box is a seed's k-th in VoteFusion.

The training half takes a batch where the JAX package maps a function of
one image over it; its assigner and sampler are ``models/assign_sample.py``
and it takes its uniform draws as arguments (the model draws them).  The
RoIAlign trains through K12 (its backward) on the card; the proposals and
the sampled RoIs take no gradient, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms2d import batched_nms_2d
from ..ops.roi_align import pyramid_roi_align, roi_levels
from ..parallel import global_sum
from ..registry import HEADS, LOSSES, build_from_cfg
from ..utils.precision import conv, dense
from .losses import sigmoid_cross_entropy


def topk_stable(x, k):
    """The ``k`` largest of ``x`` along the last axis, descending, equal
    values in index order (``jax.lax.top_k``'s order) -> (values,
    indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def grid_anchors(feat_hw, stride, scales, ratios, device=None):
    """(H * W * A, 4) xyxy anchors of one level (mmdet AnchorGenerator),
    position-major and anchor-minor; computed in numpy float32 as the JAX
    package does."""
    h, w = feat_hw
    base = stride * np.asarray(scales, np.float32)
    ratios = np.asarray(ratios, np.float32)
    h_r = np.sqrt(ratios)
    w_r = 1.0 / h_r
    ws = (base[None, :] * w_r[:, None]).reshape(-1)
    hs = (base[None, :] * h_r[:, None]).reshape(-1)
    cx = stride / 2.0
    base_anchors = np.stack(
        [cx - ws / 2, cx - hs / 2, cx + ws / 2, cx + hs / 2], -1)
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift = np.stack(np.meshgrid(sx, sy), -1).reshape(-1, 2)
    shifts = np.concatenate([shift, shift], -1)
    anchors = (shifts[:, None, :] + base_anchors[None]).reshape(-1, 4)
    return torch.as_tensor(anchors.astype(np.float32), device=device)


def _coder_terms(values, like):
    """A coder's ``means`` / ``stds`` as a float32 tensor, as the JAX
    package's ``jnp.asarray`` makes them: an array, not a weak Python
    scalar, so that bf16 deltas meeting it are computed in float32."""
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def delta2bbox(anchors, deltas, means=(0., 0., 0., 0.),
               stds=(1., 1., 1., 1.), max_shape=None, wh_ratio_clip=0.016):
    """mmdet ``DeltaXYWHBBoxCoder.decode``; ``max_shape`` (H, W), scalars
    or tensors broadcasting over the boxes' leading axes, clips the
    corners to the image.  The boxes are float32 whatever the deltas'
    dtype (the RPN's are bf16 under the bf16 policy), as in the JAX
    package."""
    d = deltas * _coder_terms(stds, deltas) + _coder_terms(means, deltas)
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(float(np.log(wh_ratio_clip)))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, *max_shape)
    return boxes


def clip_boxes(boxes, hm, wm):
    """Corners clipped to [0, wm] x [0, hm]; ``hm`` / ``wm`` broadcast
    over the boxes' leading axes."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    hm = torch.as_tensor(hm, dtype=boxes.dtype, device=boxes.device)
    wm = torch.as_tensor(wm, dtype=boxes.dtype, device=boxes.device)
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), wm),
        torch.minimum(torch.maximum(boxes[..., 1], zero), hm),
        torch.minimum(torch.maximum(boxes[..., 2], zero), wm),
        torch.minimum(torch.maximum(boxes[..., 3], zero), hm)], -1)


def bbox2delta(anchors, boxes, means=(0., 0., 0., 0.),
               stds=(1., 1., 1., 1.)):
    """mmdet ``DeltaXYWHBBoxCoder.encode``."""
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = (anchors[..., 2] - anchors[..., 0]).clamp_min(1e-6)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp_min(1e-6)
    bx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    by = (boxes[..., 1] + boxes[..., 3]) * 0.5
    bw = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    d = torch.stack([(bx - ax) / aw, (by - ay) / ah,
                     torch.log(bw / aw), torch.log(bh / ah)], -1)
    return (d - _coder_terms(means, d)) / _coder_terms(stds, d)


def _img_hw(img_shape, dtype):
    """(B, 2) image shapes -> (B, 1) heights and widths in ``dtype``."""
    shape = img_shape.to(dtype)
    return shape[:, 0:1], shape[:, 1:2]


@HEADS.register_module()
class RPNHead(nn.Module):
    """mmdet ``RPNHead``: ``rpn_conv`` (3x3, ReLU), ``rpn_cls`` (an
    objectness logit an anchor) and ``rpn_reg`` (4 deltas an anchor), on
    every level; NHWC maps in, NHWC outputs out.  Its loss configs are
    kept for ``rpn_loss``."""

    def __init__(self, in_channels=256, feat_channels=256,
                 anchor_generator=None, bbox_coder=None, loss_cls=None,
                 loss_bbox=None, train_cfg=None, test_cfg=None):
        super().__init__()
        self.anchor_generator = dict(anchor_generator or {})
        self.bbox_coder = dict(bbox_coder or {})
        self.loss_cls_cfg = loss_cls
        self.loss_bbox_cfg = loss_bbox
        ag = self.anchor_generator
        num_anchors = len(ag.get('scales', [8])) * len(
            ag.get('ratios', [0.5, 1.0, 2.0]))
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats):
        """feats: tuple of (B, H, W, C) -> a (cls (B, H, W, A), reg (B, H,
        W, 4A)) pair a level."""
        outs = []
        for f in feats:
            x = F.relu(conv(self.rpn_conv, f.permute(0, 3, 1, 2)))
            outs.append((conv(self.rpn_cls, x).permute(0, 2, 3, 1),
                         conv(self.rpn_reg, x).permute(0, 2, 3, 1)))
        return outs

    def get_proposals(self, outs, img_shape, cfg):
        """Fixed-shape proposals: each level's top ``nms_pre`` anchors by
        objectness, decoded, clipped to the image, the 2D NMS over the
        level groups (K10), then the top ``max_per_img`` kept ->
        (proposals (B, K, 4), scores (B, K), valid (B, K))."""
        ag = self.anchor_generator
        strides = list(ag.get('strides', [4, 8, 16, 32, 64]))
        scales = list(ag.get('scales', [8]))
        ratios = list(ag.get('ratios', [0.5, 1.0, 2.0]))
        coder = self.bbox_coder
        nms_pre = cfg.get('nms_pre', 1000)
        max_per_img = cfg.get('max_per_img', 1000)
        iou_thr = dict(cfg.get('nms', {})).get('iou_threshold', 0.7)

        all_scores, all_boxes, all_lvl = [], [], []
        for lvl, ((cls, reg), stride) in enumerate(zip(outs, strides)):
            b, h, w, _ = cls.shape
            anchors = grid_anchors((h, w), stride, scales, ratios,
                                   cls.device)
            scores = torch.sigmoid(cls.reshape(b, -1))
            deltas = reg.reshape(b, -1, 4)
            topv, topi = topk_stable(scores, min(nms_pre, scores.shape[1]))
            boxes = delta2bbox(
                anchors[topi],
                torch.gather(deltas, 1, topi[..., None].expand(-1, -1, 4)),
                coder.get('target_means', (0., 0., 0., 0.)),
                coder.get('target_stds', (1., 1., 1., 1.)))
            all_scores.append(topv)
            all_boxes.append(boxes)
            all_lvl.append(torch.full_like(topi, lvl))
        scores = torch.cat(all_scores, 1)
        boxes = torch.cat(all_boxes, 1)
        boxes = clip_boxes(boxes, *_img_hw(img_shape, boxes.dtype))
        keep = batched_nms_2d(boxes, scores, torch.cat(all_lvl, 1), iou_thr)
        topv, topi = topk_stable(torch.where(keep, scores, -1.0),
                                 max_per_img)
        return (torch.gather(boxes, 1, topi[..., None].expand(-1, -1, 4)),
                topv, topv > 0)


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    """mmdet ``StandardRoIHead`` with ``SingleRoIExtractor`` (pyramid
    RoIAlign, K11) and ``Shared2FCBBoxHead``: ``bbox_head.shared_fcs.{0,1}``,
    ``bbox_head.fc_cls`` (C + 1 logits), ``bbox_head.fc_reg`` (C x 4
    deltas).  The pooled RoIs are flattened in the JAX package's (7, 7, C)
    order, not mmdet's (C, 7, 7): a JAX ``shared_fc1`` kernel carries over
    by a transpose."""

    def __init__(self, bbox_roi_extractor=None, bbox_head=None,
                 train_cfg=None, test_cfg=None):
        super().__init__()
        ext = dict(bbox_roi_extractor or {})
        self.strides = list(ext.get('featmap_strides', [4, 8, 16, 32]))
        self.out_size = dict(ext.get('roi_layer', {})).get('output_size', 7)
        head = dict(bbox_head or {})
        self.head_cfg = head
        self.num_classes = head.get('num_classes', 10)
        self.test_cfg = dict(test_cfg or {})
        fc_out = head.get('fc_out_channels', 1024)
        in_channels = head.get('in_channels', 256)
        self.bbox_head = nn.Module()
        self.bbox_head.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * self.out_size ** 2, fc_out),
            nn.Linear(fc_out, fc_out)])
        self.bbox_head.fc_cls = nn.Linear(fc_out, self.num_classes + 1)
        self.bbox_head.fc_reg = nn.Linear(fc_out, self.num_classes * 4)

    def forward(self, feats, proposals):
        """feats: tuple of NHWC maps (the levels of ``featmap_strides``
        first); proposals (B, R, 4) xyxy -> cls_logits (B, R, C + 1),
        bbox_deltas (B, R, C * 4)."""
        levels = tuple(feats[:len(self.strides)])
        lvl = roi_levels(proposals, len(self.strides))
        pooled = pyramid_roi_align(levels, proposals, lvl, self.strides,
                                   self.out_size)
        b, r = proposals.shape[:2]
        x = pooled.reshape(b, r, -1)
        head = self.bbox_head
        x = F.relu(dense(x, head.shared_fcs[0]))
        x = F.relu(dense(x, head.shared_fcs[1]))
        return dense(x, head.fc_cls), dense(x, head.fc_reg)

    def get_bboxes(self, cls_logits, bbox_deltas, proposals, proposal_valid,
                   img_shape):
        """Per-class decode clipped to the image, ``score_thr``, the 2D NMS
        over the class groups (K10), the top ``max_per_img`` ->
        dict(bboxes (B, K, 5) [xyxy, score], labels (B, K), valid (B, K))."""
        coder = dict(self.head_cfg.get('bbox_coder', {}))
        c = self.num_classes
        score_thr = self.test_cfg.get('score_thr', 0.05)
        iou_thr = dict(self.test_cfg.get('nms', {})).get('iou_threshold',
                                                         0.5)
        max_per_img = self.test_cfg.get('max_per_img', 100)
        b, r = proposals.shape[:2]
        probs = torch.softmax(cls_logits, -1)[..., :c]
        hm, wm = _img_hw(img_shape, proposals.dtype)
        boxes = delta2bbox(
            proposals[:, :, None, :], bbox_deltas.reshape(b, r, c, 4),
            coder.get('target_means', (0., 0., 0., 0.)),
            coder.get('target_stds', (0.1, 0.1, 0.2, 0.2)),
            max_shape=(hm[..., None], wm[..., None]))
        flat_boxes = boxes.reshape(b, r * c, 4)
        flat_scores = probs.reshape(b, r * c)
        flat_labels = torch.arange(c, device=proposals.device).repeat(
            r)[None].expand(b, -1)
        flat_valid = proposal_valid.repeat_interleave(c, 1) & (
            flat_scores > score_thr)
        keep = batched_nms_2d(flat_boxes, flat_scores, flat_labels, iou_thr,
                              flat_valid)
        topv, topi = topk_stable(torch.where(keep, flat_scores, -1.0),
                                 max_per_img)
        return dict(
            bboxes=torch.cat([torch.gather(
                flat_boxes, 1, topi[..., None].expand(-1, -1, 4)),
                topv[..., None]], -1),
            labels=torch.gather(flat_labels, 1, topi), valid=topv > 0)


def _take(x, idx):
    """``x`` (B, N, ...) at the indices ``idx`` (B, K) of its second axis."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def rpn_anchors(outs, anchor_cfg):
    """Every level's anchors of the RPN outputs ``outs``, concatenated in
    the order of the flattened outputs -> (A, 4)."""
    strides = list(anchor_cfg.get('strides', [4, 8, 16, 32, 64]))
    scales = list(anchor_cfg.get('scales', [8]))
    ratios = list(anchor_cfg.get('ratios', [0.5, 1.0, 2.0]))
    return torch.cat([grid_anchors((c.shape[1], c.shape[2]), s, scales,
                                   ratios, c.device)
                      for (c, _), s in zip(outs, strides)], 0)


def rpn_loss(outs, anchor_cfg, coder_cfg, gt_bboxes, gt_valid, train_cfg,
             loss_cls_cfg, loss_bbox_cfg, u_pos, u_neg):
    """mmdet ``RPNHead.loss`` over every anchor: ``outs`` the RPN's (cls,
    reg) a level, ``gt_bboxes`` (B, G, 4) xyxy, ``gt_valid`` (B, G); the
    anchors assigned by ``MaxIoUAssigner`` and sampled by
    ``RandomSampler`` on the uniforms ``u_pos`` / ``u_neg`` (B, A) ->
    dict(loss_rpn_cls, loss_rpn_bbox).  The objectness
    loss is the sigmoid BCE written out, as in the JAX package, over the
    sampled anchors and divided by their count."""
    from .assign_sample import iou_2d, max_iou_assign, random_sample
    asn = dict(train_cfg.get('assigner', {}))
    smp = dict(train_cfg.get('sampler', {}))
    anchors = rpn_anchors(outs, anchor_cfg)
    b = gt_bboxes.shape[0]
    cls = torch.cat([c.reshape(b, -1) for c, _ in outs], 1)
    reg = torch.cat([r.reshape(b, -1, 4) for _, r in outs], 1)
    assigned = max_iou_assign(
        iou_2d(anchors, gt_bboxes), gt_valid, asn.get('pos_iou_thr', 0.7),
        asn.get('neg_iou_thr', 0.3), asn.get('min_pos_iou', 0.3),
        asn.get('match_low_quality', True))
    pos, neg = random_sample(assigned, smp.get('num', 256),
                             smp.get('pos_fraction', 0.5), u_pos=u_pos,
                             u_neg=u_neg)
    weights = (pos | neg).to(cls.dtype)
    deltas = bbox2delta(anchors, _take(gt_bboxes, assigned.clamp_min(0)),
                        coder_cfg.get('target_means', (0., 0., 0., 0.)),
                        coder_cfg.get('target_stds', (1., 1., 1., 1.)))
    avg = global_sum(weights.sum()).clamp_min(1.0)
    bce = sigmoid_cross_entropy(cls, pos.to(cls.dtype))
    loss_cls = (bce * weights).sum() / avg * dict(loss_cls_cfg).get(
        'loss_weight', 1.0)
    loss_bbox = build_from_cfg(dict(loss_bbox_cfg), LOSSES)(
        reg, deltas, weight=pos.to(reg.dtype)[..., None], avg_factor=avg)
    return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)


def sample_rcnn_rois(proposals, proposal_valid, gt_bboxes, gt_labels,
                     gt_valid, train_cfg, num_classes, u_pos, u_neg,
                     u_order):
    """The R-CNN's assignment and sampling with ``add_gt_as_proposals``:
    the GT boxes after the proposals (B, R + G), ``MaxIoUAssigner``,
    ``RandomSampler`` (the uniforms ``u_pos`` / ``u_neg``), then the
    ``num`` chosen rows in the order of the keys ``1 + u_order`` (all (B,
    R + G)) -> dict(rois (B, num, 4), labels (B, num; the background is
    ``num_classes``), gt_boxes (B, num, 4), pos, chosen (B, num))."""
    from .assign_sample import iou_2d, max_iou_assign, random_sample
    asn = dict(train_cfg.get('assigner', {}))
    smp = dict(train_cfg.get('sampler', {}))
    num = smp.get('num', 512)
    rois = torch.cat([proposals, gt_bboxes], 1)
    valid = torch.cat([proposal_valid, gt_valid], 1)
    ious = iou_2d(rois, gt_bboxes)
    ious = torch.where(valid[..., None], ious, torch.full_like(ious, -1.0))
    assigned = max_iou_assign(
        ious, gt_valid, asn.get('pos_iou_thr', 0.5),
        asn.get('neg_iou_thr', 0.5), asn.get('min_pos_iou', 0.5),
        asn.get('match_low_quality', False))
    assigned = torch.where(valid, assigned, -2)
    pos, neg = random_sample(assigned, num, smp.get('pos_fraction', 0.25),
                             u_pos=u_pos, u_neg=u_neg)
    chosen = pos | neg
    _, sel = topk_stable(torch.where(chosen, 1.0 + u_order,
                                     torch.zeros_like(u_order)), num)
    pos_s = torch.gather(pos, 1, sel)
    gt_of = torch.gather(assigned, 1, sel).clamp_min(0)
    labels = torch.where(pos_s, torch.gather(gt_labels.long(), 1, gt_of),
                         num_classes)
    return dict(rois=_take(rois, sel), labels=labels,
                gt_boxes=_take(gt_bboxes, gt_of), pos=pos_s,
                chosen=torch.gather(chosen, 1, sel))


def rcnn_loss(cls_logits, bbox_deltas, sampled, coder_cfg, num_classes,
              loss_cls_cfg, loss_bbox_cfg):
    """The R-CNN's classification loss over the chosen RoIs and its
    class-specific regression (the deltas of the RoI's GT class) over the
    positive ones, both divided by the count of chosen RoIs ->
    dict(loss_cls, loss_bbox)."""
    labels = sampled['labels']
    chosen = sampled['chosen'].to(cls_logits.dtype)
    avg = global_sum(chosen.sum()).clamp_min(1.0)
    loss_cls = build_from_cfg(dict(loss_cls_cfg), LOSSES)(
        cls_logits, labels, weight=chosen, avg_factor=avg)
    targets = bbox2delta(sampled['rois'], sampled['gt_boxes'],
                         coder_cfg.get('target_means', (0., 0., 0., 0.)),
                         coder_cfg.get('target_stds', (0.1, 0.1, 0.2, 0.2)))
    b, s = labels.shape
    deltas = bbox_deltas.reshape(b, s, num_classes, 4)
    cls_idx = labels.clamp(0, num_classes - 1)[..., None, None]
    picked = torch.gather(deltas, 2, cls_idx.expand(b, s, 1, 4))[:, :, 0]
    loss_bbox = build_from_cfg(dict(loss_bbox_cfg), LOSSES)(
        picked, targets, weight=sampled['pos'].to(picked.dtype)[..., None],
        avg_factor=avg)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)
