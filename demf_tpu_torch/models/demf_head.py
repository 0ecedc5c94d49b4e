"""DeMFVoteHead, inference half (port of ``demf_tpu/models/demf_head.py``):
vote -> aggregate -> first proposals, then decoder layers of self-attention
over the proposals and deformable cross-attention into the image tokens at
the proposals' projected 2D positions, each followed by a re-prediction;
``get_bboxes`` ensembles the configured stages before 3D NMS."""
from __future__ import annotations

import torch
from torch import nn

from ..core.transforms import project_points_to_image
from ..registry import HEADS
from .conv_bbox_head import BaseConvBboxHead
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

    @torch.no_grad()
    def init_weights(self, generator):
        """Start the size regression at the mean class size of the coder,
        when it has one, so untrained boxes have plausible extents."""
        if self.coder.mean_sizes is None:
            return
        mean = torch.as_tensor(self.coder.mean_sizes.mean(0),
                               dtype=torch.float32)
        for i in range(len(self.decoder) + 1):
            getattr(self, f'conv_pred{i}').conv_reg.bias[3:6] = mean

    def _predict(self, stage, feats, aggregated_points):
        cls, reg = getattr(self, f'conv_pred{stage}')(feats)
        return self.coder.split_pred(cls.transpose(1, 2),
                                     reg.transpose(1, 2), aggregated_points)

    def forward(self, feat_dict, sample_mod, img_dict):
        """feat_dict: seed_points / features / indices of the backbone;
        img_dict: 'img_features' (tuple of NHWC maps) and 'img_meta'.
        Returns the results dict with 'decode_res_all' (one per stage)."""
        results, feats = self._vote_and_aggregate(feat_dict, sample_mod)
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
                          reference_points, spatial_shapes, valid_ratios)
            decode_res_all.append(self._predict(i + 1, query, agg))
        results['decode_res_all'] = decode_res_all
        return results

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
