"""Box codecs (port of ``demf_tpu/core/coders.py``):
``ClassAgnosticBBoxCoder``, ``PartialBinBasedBBoxCoder`` and
``DeMFClassAgnosticBBoxCoder``."""
from __future__ import annotations

import numpy as np
import torch

from ..registry import BBOX_CODERS
from . import boxes as box_ops


@BBOX_CODERS.register_module()
class ClassAgnosticBBoxCoder:
    """Face-distance box codec of CAVoteHead.

    Regression layout: 6 exp()'d face distances, ``num_dir_bins`` direction
    logits, ``num_dir_bins`` normalized direction residuals.  Classification
    layout: 2 objectness (+ semantic logits when present).
    """

    def __init__(self, num_dir_bins, with_rot=True, num_sizes=0,
                 mean_sizes=None, **kwargs):
        self.num_dir_bins = num_dir_bins
        self.with_rot = with_rot
        self.num_sizes = num_sizes
        self.mean_sizes = np.asarray(mean_sizes) if mean_sizes else None

    def encode(self, gt_bboxes_3d, gt_labels_3d, ret_dir_target=False):
        """GT boxes (..., 7) -> (center, half dims, dir_class, dir_res[,
        dir])."""
        center = box_ops.gravity_center(gt_bboxes_3d)
        size = gt_bboxes_3d[..., 3:6] / 2
        yaw = gt_bboxes_3d[..., 6]
        if self.with_rot:
            dir_cls, dir_res = box_ops.angle2class(yaw, self.num_dir_bins)
            dir_target = yaw
        else:
            dir_cls = torch.zeros_like(yaw, dtype=torch.long)
            dir_res = torch.zeros_like(yaw)
            dir_target = torch.zeros_like(yaw)
        out = (center, size, dir_cls, dir_res)
        return out + (dir_target,) if ret_dir_target else out

    def _decode_angle(self, bbox_out):
        dir_class = torch.argmax(bbox_out['dir_class'], -1)
        dir_res = torch.gather(bbox_out['dir_res'], -1,
                               dir_class[..., None])[..., 0]
        angle = box_ops.class2angle(dir_class, dir_res, self.num_dir_bins)
        return torch.remainder(angle, 2 * np.pi)

    def decode(self, bbox_out):
        """Face distances + ref points -> (B, N, 7) boxes."""
        distance = bbox_out['distance']
        if self.with_rot:
            dir_angle = self._decode_angle(bbox_out)[..., None]
        else:
            dir_angle = distance.new_zeros(distance.shape[:-1] + (1,))
        bbox_size = (distance[..., 0:3] + distance[..., 3:6]).clamp_min(0.1)
        canonical = (distance[..., 3:6] - distance[..., 0:3]) / 2
        shape = canonical.shape
        canonical = box_ops.rotation_3d_in_axis(
            canonical.reshape(-1, 1, 3), dir_angle.reshape(-1),
            axis=2).reshape(shape)
        center = bbox_out['ref_points'] - canonical
        return torch.cat([center, bbox_size, dir_angle], -1)

    def split_pred(self, cls_preds, reg_preds, ref_points):
        """(B, C_cls, N), (B, C_reg, N) raw conv outputs -> named fields."""
        cls_t = cls_preds.transpose(-1, -2)
        reg_t = reg_preds.transpose(-1, -2)
        nb = self.num_dir_bins
        results = dict(distance=torch.exp(reg_t[..., 0:6]),
                       dir_class=reg_t[..., 6:6 + nb])
        results['dir_res_norm'] = reg_t[..., 6 + nb:6 + 2 * nb]
        results['dir_res'] = results['dir_res_norm'] * (np.pi / nb)
        results['obj_scores'] = cls_t[..., 0:2]
        if cls_t.shape[-1] > 2:
            results['sem_scores'] = cls_t[..., 2:]
        results['ref_points'] = ref_points
        return results

    def decode_corners(self, distance, ref_points):
        """(B, N, 6) min / max corners from face distances."""
        return torch.cat([ref_points - distance[..., 3:6],
                          ref_points + distance[..., 0:3]], -1)


@BBOX_CODERS.register_module()
class PartialBinBasedBBoxCoder:
    """The classic VoteNet codec of the standard ``VoteHead`` (mmdet3d
    ``PartialBinBasedBBoxCoder``): per-class mean sizes and binned
    directions.

    Regression layout: 3 center offsets, ``num_dir_bins`` direction logits,
    ``num_dir_bins`` normalized direction residuals, ``num_sizes`` size
    logits, ``3 * num_sizes`` normalized size residuals.  Classification
    layout: 2 objectness, then the semantic logits.
    """

    def __init__(self, num_dir_bins, num_sizes, mean_sizes, with_rot=True,
                 **kwargs):
        self.num_dir_bins = num_dir_bins
        self.num_sizes = num_sizes
        self.mean_sizes = np.asarray(mean_sizes, np.float32)
        self.with_rot = with_rot

    def _mean(self, like):
        return torch.as_tensor(self.mean_sizes, device=like.device)

    def encode(self, gt_bboxes_3d, gt_labels_3d):
        """GT boxes (..., 7), labels (...) -> (center, size class, size
        residual from the class's mean size, dir class, dir residual)."""
        center = box_ops.gravity_center(gt_bboxes_3d)
        labels = gt_labels_3d.long()
        size_res = gt_bboxes_3d[..., 3:6] - self._mean(gt_bboxes_3d)[labels]
        yaw = gt_bboxes_3d[..., 6]
        if self.with_rot:
            dir_cls, dir_res = box_ops.angle2class(yaw, self.num_dir_bins)
        else:
            dir_cls = torch.zeros_like(yaw, dtype=torch.long)
            dir_res = torch.zeros_like(yaw)
        return center, labels, size_res, dir_cls, dir_res

    def split_pred(self, cls_preds, reg_preds, base_xyz):
        """(B, C_cls, N), (B, C_reg, N) raw conv outputs -> named fields."""
        cls_t = cls_preds.transpose(-1, -2)
        reg_t = reg_preds.transpose(-1, -2)
        nb, ns = self.num_dir_bins, self.num_sizes
        results = dict(center=base_xyz + reg_t[..., 0:3],
                       dir_class=reg_t[..., 3:3 + nb])
        results['dir_res_norm'] = reg_t[..., 3 + nb:3 + 2 * nb]
        results['dir_res'] = results['dir_res_norm'] * (np.pi / nb)
        start = 3 + 2 * nb
        results['size_class'] = reg_t[..., start:start + ns]
        start += ns
        size_res_norm = reg_t[..., start:start + 3 * ns]
        results['size_res_norm'] = size_res_norm.reshape(
            size_res_norm.shape[:-1] + (ns, 3))
        results['size_res'] = results['size_res_norm'] * self._mean(reg_t)
        results['obj_scores'] = cls_t[..., 0:2]
        results['sem_scores'] = cls_t[..., 2:]
        return results

    def decode(self, bbox_out):
        """Named fields -> (B, N, 7) boxes: the arg-max size class's mean
        size plus its residual (at least 0.1), the arg-max direction bin."""
        center = bbox_out['center']
        if self.with_rot:
            dir_class = torch.argmax(bbox_out['dir_class'], -1)
            dir_res = torch.gather(bbox_out['dir_res'], -1,
                                   dir_class[..., None])[..., 0]
            dir_angle = box_ops.class2angle(dir_class, dir_res,
                                            self.num_dir_bins)[..., None]
        else:
            dir_angle = center.new_zeros(center.shape[:-1] + (1,))
        size_class = torch.argmax(bbox_out['size_class'], -1)
        size_res = torch.gather(
            bbox_out['size_res'], -2,
            size_class[..., None, None].expand(
                size_class.shape + (1, 3)))[..., 0, :]
        mean = self._mean(center)[size_class]
        return torch.cat([center, (mean + size_res).clamp_min(0.1),
                          dir_angle], -1)


@BBOX_CODERS.register_module()
class DeMFClassAgnosticBBoxCoder(ClassAgnosticBBoxCoder):
    """Center + size codec of DeMFVoteHead."""

    def encode(self, gt_bboxes_3d, gt_labels_3d, ret_dir_target=False):
        """As the parent's, with full box dims."""
        out = list(super().encode(gt_bboxes_3d, gt_labels_3d,
                                  ret_dir_target))
        out[1] = gt_bboxes_3d[..., 3:6]
        return tuple(out)

    def decode(self, bbox_out):
        center = bbox_out['center']
        if self.with_rot:
            dir_angle = self._decode_angle(bbox_out)[..., None]
        else:
            dir_angle = center.new_zeros(center.shape[:-1] + (1,))
        return torch.cat([center, bbox_out['size'], dir_angle], -1)

    def split_pred(self, cls_preds, reg_preds, base_xyz):
        """(B, C_cls, N), (B, C_reg, N) raw conv outputs -> named fields."""
        cls_t = cls_preds.transpose(-1, -2)
        reg_t = reg_preds.transpose(-1, -2)
        nb = self.num_dir_bins
        results = dict(center=base_xyz + reg_t[..., 0:3],
                       size=reg_t[..., 3:6],
                       dir_class=reg_t[..., 6:6 + nb])
        results['dir_res_norm'] = reg_t[..., 6 + nb:6 + 2 * nb]
        results['dir_res'] = results['dir_res_norm'] * (np.pi / nb)
        results['obj_scores'] = cls_t[..., 0:2]
        if cls_t.shape[-1] > 2:
            results['sem_scores'] = cls_t[..., 2:]
        return results

    def decode_corners(self, center, size):
        half = size / 2.0
        return torch.cat([center - half, center + half], -1)
