"""FCAF3D, the anchor-free sparse-voxel detector, served (port of
``demf_tpu/models/fcaf3d.py``): voxelize -> MinkResNet -> ``FCAF3DHead``
(a top-down decoder of generative transpose convs onto the skip levels'
voxels, an out block a level, shared per-voxel centerness / 8-dof
regression with the Moebius yaw / classification) -> ``get_bboxes``
(the top ``nms_pre`` candidates a scene, one rotated IoU matrix and one
greedy sweep a class: kernel K15, ``ops/nms_rotated.py``).

The targets and the loss (``get_targets`` / ``loss``) come with the
training slice (ROADMAP M8, the training half); until then the detector
stays in eval mode and refuses ``train()``, and ``loss`` raises, by
name.  Module names are mmdet3d's (``up_block_{i}.{0,1,3,4}``,
``out_block_{i}.{0,1}``, ``centerness_conv`` / ``reg_conv`` /
``cls_conv``), sparse kernels in MinkowskiEngine's tap order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sparse as S
from ..ops.nms_rotated import rotated_nms_classwise
from ..registry import BACKBONES, DETECTORS, HEADS, build_from_cfg
from ..utils.precision import cast_compute
from .mink_resnet import MaskedBatchNorm, SparseConv
from .rpn_roi import topk_stable

TRAINING_NOT_PORTED = ('training the FCAF3D family is not ported yet '
                       '(ROADMAP M8, the training half): the port serves it')


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
                  nbr):
        """Generative transpose conv (k=2, s=2) onto the skip level's voxels,
        then a 3x3x3 conv, each with BN and ELU."""
        tconv, tbn, _, conv, bn, _ = getattr(self, f'up_block_{i}')
        cc, cv, cf = coarse
        y = S.transposed_conv_to_batched(
            fine_coords, fine_valid, cc, cv, cf, tconv.taps,
            tensor_stride=fine_stride, sorted_input=True)
        y = F.elu(tbn(y, fine_valid))
        y = S.submanifold_conv_batched(fine_coords, fine_valid, y, conv.taps,
                                       tensor_stride=fine_stride, nbr=nbr)
        y = F.elu(bn(y, fine_valid))
        return torch.where(fine_valid[..., None], y, 0)

    def _out_block(self, i, coords, valid, x, stride, nbr):
        conv, bn, _ = getattr(self, f'out_block_{i}')
        y = S.submanifold_conv_batched(coords, valid, x, conv.taps,
                                       tensor_stride=stride, nbr=nbr)
        y = F.elu(bn(y, valid))
        return torch.where(valid[..., None], y, 0)

    def forward(self, backbone_outs):
        """backbone_outs: the stages' (coords, valid, feats[, nbr]), fine to
        coarse -> per-level dicts (fine to coarse) of centerness (B, M),
        bbox_pred (B, M, 8), cls_scores (B, M, C), points (B, M, 3) in
        metres, valid and the out block's features."""
        n = len(backbone_outs)
        strides = [8 * 2 ** i for i in range(n)]
        outs = []
        x = None
        for i in range(n - 1, -1, -1):
            entry = backbone_outs[i]
            coords, valid, feats = entry[:3]
            nbr = entry[3] if len(entry) > 3 else S.neighbor_table_batched(
                coords, valid, coords, valid,
                S.kernel_offsets(3, True, coords.device),
                in_stride=strides[i], sorted_input=True)
            if i < n - 1:
                feats = feats + self._up_block(i + 1, x, coords, valid,
                                               strides[i], nbr)
            x = (coords, valid, feats)
            of = self._out_block(i, coords, valid, feats, strides[i], nbr)
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

    def loss(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_NOT_PORTED)

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

    def train(self, mode=True):
        """Eval mode only: training is refused (``TRAINING_NOT_PORTED``)."""
        if mode:
            raise NotImplementedError(TRAINING_NOT_PORTED)
        return nn.Module.train(self, False)

    def extract_feat(self, batch):
        coords, feats, valid = voxelize_batch(
            batch['points'], self.voxel_size, self.pc_start, self.max_voxels)
        return self.backbone(coords, valid, feats)

    def forward(self, batch, generator=None):
        return dict(head_outs=self.head(self.extract_feat(batch)))

    def loss(self, results, batch):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def get_bboxes(self, results, batch=None):
        return self.head.get_bboxes(self.head.pools(results))
