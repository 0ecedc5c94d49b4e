"""FCAF3D, the anchor-free sparse-voxel detector (port of
``demf_tpu/models/fcaf3d.py``): voxelize -> MinkResNet -> ``FCAF3DHead``
(a top-down decoder of generative transpose convs onto the skip levels'
voxels, an out block a level, shared per-voxel centerness / 8-dof
regression with the Moebius yaw / classification) -> ``get_bboxes``
(the top ``nms_pre`` candidates a scene, one rotated IoU matrix and one
greedy sweep a class: kernel K15, ``ops/nms_rotated.py``).

Training: ``get_targets`` (each box's level by ``pts_assign_threshold``,
its top ``pts_center_threshold`` voxels by centerness, the least-volume
box a voxel) and ``loss`` (focal classification over the valid voxels,
centerness BCE on the positives, the rotated-IoU loss weighted by
centerness), batched over the scenes; the sparse convolutions' backward
is ``ops/sparse.py``'s (K14 on reverse tables, K16).  The family trains
in float32 and under the bf16 policy (bf16 copies of the float32 weights,
bf16 voxel features, float32 norms, K14 and K16 on their bf16 entries).
Module names are mmdet3d's (``up_block_{i}.{0,1,3,4}``,
``out_block_{i}.{0,1}``, ``centerness_conv`` / ``reg_conv`` /
``cls_conv``), sparse kernels in MinkowskiEngine's tap order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.rotated_iou import iou3d_aligned
from ..ops import sparse as S
from ..ops.nms_rotated import rotated_nms_classwise
from ..registry import BACKBONES, DETECTORS, HEADS, build_from_cfg
from ..utils.precision import cast_compute
from .losses import FocalLoss, sigmoid_cross_entropy
from .mink_resnet import MaskedBatchNorm, SparseConv
from .rpn_roi import topk_stable

FLOAT_MAX = 1e8
# a non-positive voxel's box prediction before the decode (its IoU loss
# weighs 0; the dummy keeps its gradient finite)
DUMMY_BBOX_PRED = (0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.1, 0.1)


def concat_levels(head_outs, keys=('centerness', 'bbox_pred', 'cls_scores',
                                   'points', 'valid')):
    """The levels' per-voxel outputs joined along the voxel axis."""
    return {k: torch.cat([o[k] for o in head_outs], 1) for k in keys}


def take_rows(x, idx):
    """x (B, N, ...) at rows idx (B, K)."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        *idx.shape, *x.shape[2:]))


@HEADS.register_module()
class FCAF3DHead(nn.Module):
    """mmdet3d FCAF3DHead (SUN RGB-D: n_reg_outs 8, with yaw)."""

    def __init__(self, in_channels=(64, 128, 256, 512), out_channels=128,
                 n_classes=10, n_reg_outs=8, voxel_size=0.01,
                 pc_start=(0.0, 0.0, 0.0), pts_assign_threshold=27,
                 pts_center_threshold=18, pts_prune_threshold=100000,
                 center_loss_weight=1.0, bbox_loss_weight=1.0,
                 cls_loss_weight=1.0, test_cfg=None, train_cfg=None):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.out_channels = out_channels
        self.n_classes = n_classes
        self.n_reg_outs = n_reg_outs
        self.voxel_size = voxel_size
        self.pc_start = tuple(pc_start)
        self.test_cfg = test_cfg
        self.pts_assign_threshold = pts_assign_threshold
        self.pts_center_threshold = pts_center_threshold
        self.center_loss_weight = center_loss_weight
        self.bbox_loss_weight = bbox_loss_weight
        self.cls_loss_weight = cls_loss_weight
        n = len(self.in_channels)
        for i in range(1, n):
            cin, cout = self.in_channels[i], self.in_channels[i - 1]
            self.add_module(f'up_block_{i}', nn.Sequential(
                SparseConv(cin, cout, 2), MaskedBatchNorm(cout), nn.ELU(),
                SparseConv(cout, cout, 3), MaskedBatchNorm(cout), nn.ELU()))
        for i in range(n):
            self.add_module(f'out_block_{i}', nn.Sequential(
                SparseConv(self.in_channels[i], out_channels, 3),
                MaskedBatchNorm(out_channels), nn.ELU()))
        self.centerness_conv = SparseConv(out_channels, 1, 1)
        self.reg_conv = SparseConv(out_channels, n_reg_outs, 1)
        self.cls_conv = SparseConv(out_channels, n_classes, 1, bias=True)

    def init_weights(self, generator):
        """The classification prior of 0.01, as the JAX package's init."""
        with torch.no_grad():
            self.cls_conv.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def _up_block(self, i, coarse, fine_coords, fine_valid, fine_stride,
                  table, up_nbr, up_rev):
        """Generative transpose conv (k=2, s=2) onto the skip level's voxels
        (its table ``up_nbr``, its reverse ``up_rev``), then a 3x3x3 conv on
        the level's ``table`` (nbr, plan, rev), each with BN and ELU."""
        tconv, tbn, _, conv, bn, _ = getattr(self, f'up_block_{i}')
        cc, cv, cf = coarse
        y = S.transposed_conv_to_batched(
            fine_coords, fine_valid, cc, cv, cf, tconv.taps,
            tensor_stride=fine_stride, sorted_input=True, nbr=up_nbr,
            rev=up_rev)
        y = F.elu(tbn(y, fine_valid))
        y = S.submanifold_conv_batched(
            fine_coords, fine_valid, y, conv.taps, tensor_stride=fine_stride,
            nbr=table[0], plan=table[1], rev=table[2])
        y = F.elu(bn(y, fine_valid))
        return torch.where(fine_valid[..., None], y, 0)

    def _out_block(self, i, coords, valid, x, stride, table):
        conv, bn, _ = getattr(self, f'out_block_{i}')
        y = S.submanifold_conv_batched(coords, valid, x, conv.taps,
                                       tensor_stride=stride, nbr=table[0],
                                       plan=table[1], rev=table[2])
        y = F.elu(bn(y, valid))
        return torch.where(valid[..., None], y, 0)

    def forward(self, backbone_outs):
        """backbone_outs: the stages' (coords, valid, feats, nbr, plan, rev,
        down) as ``MinkResNet`` returns them, fine to coarse -> per-level
        dicts (fine to coarse) of centerness (B, M), bbox_pred (B, M, 8),
        cls_scores (B, M, C), points (B, M, 3) in metres, valid and the out
        block's features.  An up block's transposed conv takes the next
        stage's ``down`` (its strided table and plan) as its reverse: the
        backward makes neither anew."""
        n = len(backbone_outs)
        strides = [8 * 2 ** i for i in range(n)]
        up_nbrs = self.up_tables(backbone_outs, strides)
        outs = []
        x = None
        for i in range(n - 1, -1, -1):
            coords, valid, feats, nbr, plan, rev, _ = backbone_outs[i]
            table = (nbr, plan, rev)
            if i < n - 1:
                feats = feats + self._up_block(i + 1, x, coords, valid,
                                               strides[i], table,
                                               up_nbrs[i],
                                               backbone_outs[i + 1][6])
            x = (coords, valid, feats)
            of = self._out_block(i, coords, valid, feats, strides[i], table)
            reg = self.reg_conv.dense(of)
            points = coords.float() * self.voxel_size + coords.new_tensor(
                self.pc_start, dtype=torch.float32)
            outs.append(dict(
                centerness=self.centerness_conv.dense(of)[..., 0],
                bbox_pred=torch.cat([torch.exp(reg[..., :6]), reg[..., 6:]],
                                    -1),
                cls_scores=self.cls_conv.dense(of), points=points,
                valid=valid, features=of))
        return outs[::-1]

    @staticmethod
    def up_tables(backbone_outs, strides):
        """The up blocks' transposed-conv tables, all known from the
        backbone's levels: level i's voxels looked up among level i + 1's,
        one K13 launch for all of them."""
        jobs = [S.parent_job(fine[0], fine[1], coarse[0], coarse[1],
                             tensor_stride=s)
                for fine, coarse, s in zip(backbone_outs, backbone_outs[1:],
                                           strides)]
        return S.kernel_tables(jobs) if jobs else []

    @staticmethod
    def bbox_pred_to_bbox(points, bbox_pred):
        """The 8-dof decode (face distances + Moebius yaw) -> (..., 7)
        boxes with the bottom z."""
        x = points[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
        y = points[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
        z = points[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
        scale = (bbox_pred[..., 0] + bbox_pred[..., 1] + bbox_pred[..., 2] +
                 bbox_pred[..., 3])
        q1 = bbox_pred[..., 6]
        q2 = bbox_pred[..., 7]
        q = torch.exp(torch.sqrt(q1 ** 2 + q2 ** 2 + 1e-12))
        alpha = 0.5 * torch.atan2(q1, torch.where(
            (q1.abs() + q2.abs()) < 1e-8, torch.full_like(q2, 1e-8), q2))
        dx = scale / (1 + q)
        dy = scale * q / (1 + q)
        dz = bbox_pred[..., 5] + bbox_pred[..., 4]
        return torch.stack([x, y, z - dz / 2, dx, dy, dz, alpha], -1)

    @staticmethod
    def _face_distances(points, boxes):
        """(B, N, 3) points x (B, G, 7) boxes -> (B, N, G, 6) signed
        distances to each box's faces in its yaw frame (mmdet3d
        ``_get_face_distances``)."""
        centers = boxes[..., :3] + torch.cat(
            [torch.zeros_like(boxes[..., :2]), boxes[..., 5:6] / 2], -1)
        shift = points[:, :, None, :] - centers[:, None]
        yaw = boxes[..., 6]
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        lx = shift[..., 0] * c - shift[..., 1] * s
        ly = shift[..., 0] * s + shift[..., 1] * c
        lz = shift[..., 2]
        half = boxes[:, None, :, 3:6] / 2
        return torch.stack([half[..., 0] + lx, half[..., 0] - lx,
                            half[..., 1] + ly, half[..., 1] - ly,
                            half[..., 2] + lz, half[..., 2] - lz], -1)

    @staticmethod
    def _centerness(face):
        """The square root of the per-axis min / max distance ratios'
        product (FCOS in 3D), in the JAX package's order of operations."""
        x, y, z = face[..., 0:2], face[..., 2:4], face[..., 4:6]
        r = (x.min(-1).values / x.max(-1).values.clamp(min=1e-6) *
             y.min(-1).values / y.max(-1).values.clamp(min=1e-6) *
             z.min(-1).values / z.max(-1).values.clamp(min=1e-6))
        return torch.sqrt(r.clamp(min=0.0))

    def get_targets(self, points, levels, pt_valid, gt_bboxes, gt_labels,
                    gt_valid):
        """points (B, N, 3) of all levels, levels (N,) each voxel's level,
        pt_valid (B, N), GT boxes (B, G, 7), labels (B, G), gt_valid (B, G)
        -> (centerness target (B, N), box target (B, N, 7), labels (B, N),
        -1 the background).  A box takes the coarsest level before the first
        with fewer than ``pts_assign_threshold`` of its voxels inside (the
        last level if none has too few), its voxels there with a centerness
        above its (k + 1)-th largest (k = ``pts_center_threshold``), and a
        voxel the box of least volume among those that take it."""
        n_levels = len(self.in_channels)
        face = self._face_distances(points, gt_bboxes)
        inside = (face.min(-1).values > 0) & gt_valid[:, None] & \
            pt_valid[..., None]
        at = levels[:, None] == torch.arange(n_levels,
                                             device=levels.device)
        n_pos = (inside[:, :, None] & at[None, :, :, None]).sum(1)
        too_few = n_pos < self.pts_assign_threshold          # (B, L, G)
        # bool has no argmax: the first level with too few, as JAX's
        first_fail = too_few.int().argmax(1)
        best = torch.where(too_few.any(1), (first_fail - 1).clamp(min=0),
                           n_levels - 1)
        level_ok = best[:, None, :] == levels[None, :, None]
        centerness = self._centerness(face)                  # (B, N, G)
        cand = inside & level_ok
        cent_masked = torch.where(cand, centerness, -1.0)
        # only the value of the (k + 1)-th is used: ties do not matter
        top = cent_masked.topk(self.pts_center_threshold + 1, 1).values[
            :, -1]
        cond = cand & (cent_masked > top[:, None])
        volumes = gt_bboxes[..., 3] * gt_bboxes[..., 4] * gt_bboxes[..., 5]
        vol = torch.where(cond, volumes[:, None], FLOAT_MAX)
        min_vol, min_idx = vol.min(-1).values, vol.argmin(-1)
        pos = min_vol < FLOAT_MAX
        labels = torch.where(pos, gt_labels.long().gather(1, min_idx), -1)
        cent_t = torch.where(pos, centerness.gather(
            2, min_idx[..., None])[..., 0], 0.0)
        return cent_t, take_rows(gt_bboxes, min_idx), labels

    def targets(self, head_outs, gt_bboxes, gt_labels, gt_valid):
        """The levels' outputs joined and their targets (no gradient)."""
        cat = concat_levels(head_outs)
        levels = torch.cat([torch.full(o['points'].shape[1:2], i,
                                       device=o['points'].device)
                            for i, o in enumerate(head_outs)])
        with torch.no_grad():
            return cat, self.get_targets(cat['points'], levels, cat['valid'],
                                         gt_bboxes.float(), gt_labels,
                                         gt_valid)

    def named_losses(self, outs, cent_t, bbox_t, labels, suffix=''):
        """``loss_cls``, ``loss_centerness`` and ``loss_bbox`` (with
        ``suffix``) of per-voxel outputs ``outs`` (centerness, bbox_pred,
        cls_scores, points, valid) against their targets: each the mean over
        the scenes of a scene's loss, times its weight.  A scene's: focal
        over the valid voxels and centerness BCE on the positives, each over
        the positives' count, and 1 - the rotated IoU of the decoded box,
        weighted by its centerness target.  A non-positive voxel decodes
        ``DUMMY_BBOX_PRED`` against itself, both sides with no gradient but
        the decode's, as the JAX package."""
        cls = outs['cls_scores']
        b, n, c = cls.shape
        pos = (labels >= 0) & outs['valid']
        n_pos = pos.sum(1).clamp(min=1)
        focal = FocalLoss(use_sigmoid=True, gamma=2.0, alpha=0.25,
                          reduction='none')
        cls_loss = focal(cls.reshape(b * n, c),
                         torch.where(pos, labels, self.n_classes).reshape(-1),
                         weight=outs['valid'].reshape(-1).float()).reshape(
                             b, n, c).sum((1, 2)) / n_pos
        center_loss = torch.where(pos, sigmoid_cross_entropy(
            outs['centerness'], cent_t), 0.0).sum(1) / n_pos
        bbox_pred = outs['bbox_pred']
        bbox_safe = torch.where(pos[..., None], bbox_pred,
                                bbox_pred.new_tensor(DUMMY_BBOX_PRED))
        decoded = self.bbox_pred_to_bbox(outs['points'], bbox_safe)
        safe_t = torch.where(pos[..., None], bbox_t, decoded.detach())
        iou = iou3d_aligned(decoded.reshape(-1, 7),
                            safe_t.detach().reshape(-1, 7)).reshape(b, n)
        w = torch.where(pos, cent_t, 0.0)
        bbox_loss = ((1.0 - iou) * w).sum(1) / w.sum(1).clamp(min=1e-6)
        return {f'loss_cls{suffix}': self.cls_loss_weight * cls_loss.mean(),
                f'loss_centerness{suffix}':
                    self.center_loss_weight * center_loss.mean(),
                f'loss_bbox{suffix}': self.bbox_loss_weight * bbox_loss.mean()}

    def loss(self, head_outs, gt_bboxes, gt_labels, gt_valid):
        """The batch's loss over every level (mmdet3d
        ``FCAF3DHead._loss``)."""
        cat, targets = self.targets(head_outs, gt_bboxes, gt_labels,
                                    gt_valid)
        return self.named_losses(cat, *targets)

    def pools(self, results):
        """The per-voxel outputs that ``get_bboxes`` draws candidates from:
        every level."""
        return results['head_outs']

    def candidates(self, head_outs):
        """The top ``nms_pre`` voxels of each scene by their best class
        score -> (boxes (B, k, 7), class scores (B, k, C), valid (B, k)),
        what the class-wise NMS takes."""
        nms_pre = int(dict(self.test_cfg or {}).get('nms_pre', 256))
        cat = concat_levels(head_outs)
        probs = torch.sigmoid(cat['cls_scores']) * \
            torch.sigmoid(cat['centerness'])[..., None]
        best = torch.where(cat['valid'], probs.max(-1).values,
                           torch.full_like(probs[..., 0], -1.0))
        topv, topi = topk_stable(best, min(nms_pre, best.shape[1]))
        boxes = self.bbox_pred_to_bbox(take_rows(cat['points'], topi),
                                       take_rows(cat['bbox_pred'], topi))
        return boxes, take_rows(probs, topi), topv > 0

    def get_bboxes(self, head_outs):
        """Pools of per-voxel outputs (a list of dicts) -> padded detections
        boxes_3d (B, C * k, 7), scores_3d, labels_3d and valid (B, C * k),
        class-major, as the JAX package returns them."""
        tcfg = dict(self.test_cfg or {})
        boxes, probs, valid = self.candidates(head_outs)
        keep = rotated_nms_classwise(boxes, probs, valid,
                                     float(tcfg.get('iou_thr', 0.5)),
                                     float(tcfg.get('score_thr', 0.01)))
        b, c, k = keep.shape
        labels = torch.arange(c, device=keep.device)[None, :, None].expand(
            b, c, k)
        return dict(
            boxes_3d=boxes[:, None].expand(b, c, k, 7).reshape(b, c * k, 7),
            scores_3d=probs.transpose(1, 2).reshape(b, c * k),
            labels_3d=labels.reshape(b, c * k), valid=keep.reshape(b, c * k))


def voxelize_batch(points, voxel_size, pc_start, max_voxels):
    """(B, P, >=6) xyz + rgb points -> the voxel tables; only the pooled
    features go to the policy's compute dtype."""
    coords, feats, valid = S.voxelize(points[..., :3], points[..., 3:6],
                                      voxel_size, pc_start, max_voxels)
    return coords, cast_compute(feats), valid


@DETECTORS.register_module()
class FCAF3D(nn.Module):
    """MinkSingleStage3DDetector: voxelize -> MinkResNet -> FCAF3DHead.
    A batch holds ``points`` (B, P, >= 6: xyz + rgb)."""

    # what the step-time measurements run it on (``zoo.synth_batch_for``):
    # batch maker, scenes, GT slots
    synth_batch = ('fcaf3d', 8, 16)

    def __init__(self, backbone=None, head=None, voxel_size=0.01,
                 max_voxels=24576, pc_start=(-3.2, -0.2, -2.0),
                 train_cfg=None, test_cfg=None):
        super().__init__()
        self.voxel_size = voxel_size
        self.max_voxels = max_voxels
        self.pc_start = tuple(pc_start)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.backbone = build_from_cfg(backbone, BACKBONES)
        head = dict(head)
        head.setdefault('test_cfg', test_cfg)
        head.setdefault('pc_start', self.pc_start)
        self.head = build_from_cfg(head, HEADS)
        self.eval()

    def frozen_param_patterns(self):
        return []

    def extract_feat(self, batch):
        coords, feats, valid = voxelize_batch(
            batch['points'], self.voxel_size, self.pc_start, self.max_voxels)
        return self.backbone(coords, valid, feats)

    def forward(self, batch, generator=None):
        return dict(head_outs=self.head(self.extract_feat(batch)))

    def loss(self, results, batch):
        return self.head.loss(results['head_outs'], batch['gt_bboxes_3d'],
                              batch['gt_labels_3d'], batch['gt_valid'])

    def get_bboxes(self, results, batch=None):
        return self.head.get_bboxes(self.head.pools(results))
