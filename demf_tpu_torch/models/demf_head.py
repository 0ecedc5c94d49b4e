"""DeMFVoteHead (port of ``demf_tpu/models/demf_head.py``): vote ->
aggregate -> first proposals, then decoder layers of self-attention over
the proposals and deformable cross-attention into the image tokens at the
proposals' projected 2D positions, each followed by a re-prediction.  The
loss is the mean over all prediction stages; ``get_bboxes`` ensembles the
configured stages before 3D NMS."""
from __future__ import annotations

import torch
from torch import nn

from ..core.transforms import project_points_to_image
from ..registry import HEADS
from .conv_bbox_head import BaseConvBboxHead
from .target_assign import get_vote_head_targets
from .transformer import (DeMFTransformerDecoderLayer, get_valid_ratios,
                          make_level_masks)
from .vote_head import CAVoteHead, multiclass_nms_3d


@HEADS.register_module()
class DeMFVoteHead(CAVoteHead):
    def __init__(self, decoder=None, **kwargs):
        super().__init__(**kwargs)
        dec = dict(decoder)
        dec.pop('type', None)
        num_layers = dec.get('num_layers', 1)
        pred = dict(self.pred_layer_cfg)
        n_stages = pred.pop('conv_pred_layers')
        if n_stages != num_layers + 1:
            raise ValueError('conv_pred_layers must equal num_layers + 1')
        self.decoder = nn.ModuleList(
            [DeMFTransformerDecoderLayer(**dec) for _ in range(num_layers)])
        for i in range(n_stages):
            self.add_module(f'conv_pred{i}', BaseConvBboxHead(
                **pred, num_cls_out_channels=self._cls_out_channels(),
                num_reg_out_channels=self._reg_out_channels()))

    def _build_conv_pred(self):
        """The stages ``conv_pred{i}`` are built in ``__init__``."""

    def _predict(self, stage, feats, aggregated_points):
        cls, reg = getattr(self, f'conv_pred{stage}')(feats)
        return self.coder.split_pred(cls.transpose(1, 2),
                                     reg.transpose(1, 2), aggregated_points)

    def forward(self, feat_dict, sample_mod, img_dict, generator=None):
        """feat_dict: seed_points / features / indices of the backbone;
        img_dict: 'img_features' (tuple of NHWC maps) and 'img_meta';
        ``generator`` draws the dropout masks and the 'random' samples.
        Returns the results dict with 'decode_res_all' (one per stage).

        Only the query positions are detached; the reference points keep
        their gradient, which flows back through the projection into the
        votes."""
        results, feats = self._vote_and_aggregate(feat_dict, sample_mod,
                                                  generator)
        agg = results['aggregated_points']
        decode_res_all = [self._predict(0, feats, agg)]

        mlvl_feats = img_dict['img_features']
        meta = img_dict['img_meta']
        spatial_shapes = tuple((f.shape[1], f.shape[2]) for f in mlvl_feats)
        batch_hw = (mlvl_feats[0].shape[1] * 8, mlvl_feats[0].shape[2] * 8)
        masks = make_level_masks(meta['img_shape'], batch_hw, spatial_shapes)
        valid_ratios = get_valid_ratios(masks)
        feat_flatten = torch.cat(
            [f.reshape(f.shape[0], -1, f.shape[-1]) for f in mlvl_feats], 1)
        mask_flatten = torch.cat([m.reshape(m.shape[0], -1) for m in masks],
                                 1)
        reference_points = project_points_to_image(agg, meta)

        query = feats
        for i, layer in enumerate(self.decoder):
            dec = decode_res_all[-1]
            query_pos_input = torch.cat([dec['center'], dec['size']],
                                        -1).detach()
            query = layer(query, feat_flatten, query_pos_input, mask_flatten,
                          reference_points, spatial_shapes, valid_ratios,
                          generator)
            decode_res_all.append(self._predict(i + 1, query, agg))
        results['decode_res_all'] = decode_res_all
        return results

    def loss(self, results, points, gt_bboxes_3d, gt_labels_3d, gt_valid):
        """Mean over all prediction stages of the DeMF per-stage loss; the
        targets depend only on the shared aggregated points and are
        computed once."""
        targets = get_vote_head_targets(
            points, gt_bboxes_3d, gt_labels_3d, gt_valid,
            results['aggregated_points'], self.coder, self.train_cfg,
            self.vote_module.gt_per_seed, mode='demf')
        vote_loss = self.vote_module.get_loss(
            results['seed_points'], results['vote_points'],
            results['seed_indices'], targets['vote_target_masks'],
            targets['vote_targets'])
        stages = results['decode_res_all']
        n = len(stages)
        fns = {name: self.build_loss(name) for name in (
            'objectness_loss', 'size_res_loss', 'center_loss',
            'dir_class_loss', 'dir_res_loss', 'semantic_loss', 'iou_loss')
            if self.loss_cfgs.get(name) is not None}
        blw = targets['box_loss_weights']
        dir_cls = targets['dir_class_targets']
        losses = {}

        def acc(key, value):
            losses[key] = losses.get(key, 0.) + value / n

        for dec in stages:
            acc('vote_loss', vote_loss)
            acc('objectness_loss', fns['objectness_loss'](
                dec['obj_scores'], targets['objectness_targets'],
                weight=targets['objectness_weights']))
            acc('size_res_loss', fns['size_res_loss'](
                dec['size'], targets['size_targets'], weight=blw[..., None]))
            acc('center_loss', fns['center_loss'](
                dec['center'], targets['center_targets'],
                weight=blw[..., None]))
            acc('dir_class_loss', fns['dir_class_loss'](
                dec['dir_class'], dir_cls, weight=blw))
            dir_res_norm = torch.gather(dec['dir_res_norm'], -1,
                                        dir_cls[..., None])[..., 0]
            acc('dir_res_loss', fns['dir_res_loss'](
                dir_res_norm, targets['dir_res_targets'], weight=blw))
            if self.with_semantic:
                acc('semantic_loss', fns['semantic_loss'](
                    dec['sem_scores'], targets['mask_targets'], weight=blw))
            if 'iou_loss' in fns:
                acc('iou_loss', fns['iou_loss'](
                    self.coder.decode_corners(dec['center'], dec['size']),
                    self.coder.decode_corners(targets['center_targets'],
                                              targets['size_targets']),
                    weight=blw))
        return losses

    def get_bboxes(self, points, results):
        """Ensemble the configured stages, then multiclass 3D NMS."""
        obj, sem, boxes = [], [], []
        for i in self.test_cfg['ensemble_layers']:
            dec = results['decode_res_all'][i]
            obj.append(dec['obj_scores'].softmax(-1)[..., -1])
            sem.append(dec['sem_scores'].softmax(-1))
            boxes.append(self.coder.decode(dec))
        return multiclass_nms_3d(torch.cat(obj, 1), torch.cat(sem, 1),
                                 torch.cat(boxes, 1), points, self.test_cfg)
