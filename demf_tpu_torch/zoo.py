"""Build the port's detector and its trainer from the shared ``configs/``,
the tiny DeMF, DETR-pretrain, VoteNet, ImVoteNet and Faster R-CNN model
configs of the CPU runs, and synthetic batches (numpy) with the fields,
shapes and meta of ``demf_tpu.zoo.synth_points_batch``,
``synth_demf_batch``, ``synth_detr2d_batch`` and ``synth_fcaf3d_batch``,
value for value from the same seed."""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from .registry import DETECTORS, build_from_cfg
from .utils.config import Config

# the configs are data that both packages build from; they import nothing
CFG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                       'configs')

_DEPTH2CAM = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)


def load_model_cfg(rel_path):
    """The config at ``rel_path`` under the repository's ``configs/``."""
    return Config.fromfile(os.path.join(CFG_DIR, rel_path))


def _device(device):
    """``device`` as a ``torch.device``; raises when it names the card and
    there is none (nothing carries on on the CPU by itself)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds its models on the GPU; pass "
            "device='cpu' for a small model on the CPU")
    return device


def build_detector(model_cfg, device='cuda', seed=0):
    """Detector from a model cfg dict (or a path under ``configs/``) with
    seeded random weights, in eval mode on ``device``: the card unless the
    caller passes ``'cpu'``; raises without a card."""
    from . import models
    device = _device(device)
    if isinstance(model_cfg, str):
        model_cfg = load_model_cfg(model_cfg).model
    model = build_from_cfg(model_cfg, DETECTORS)
    models.init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_trainer(cfg, device='cuda', seed=0, steps_per_epoch=1,
                  preprocess=None):
    """Detector (seeded random weights, train mode) plus its AdamW and train
    step, as the JAX package's ``train.py`` and ``bench.py`` set them up:
    the config's optimizer with the frozen image branch at lr_mult 0, its
    step LR schedule and its grad clip.  The schedule's milestones are
    epochs: pass the loader's length as ``steps_per_epoch`` (the default of
    1 makes them step counts).

    ``cfg``: a path under ``configs/``, or a config / dict with ``model``,
    ``optimizer`` and optionally ``optimizer_config``, ``lr_config`` and
    ``bf16`` / ``fp16`` (the bf16 policy of ``utils/precision.py``).
    ``device`` as in ``build_detector``; ``preprocess`` goes to the
    ``TrainStep`` (on-device preprocessing of raw batches).  Returns
    (model, optimizer, train_step).  A detector whose training is not
    ported yet (the FCAF3D family) refuses train mode by name.
    """
    from .engine.optim import build_optimizer, step_lr_schedule
    from .engine.trainer import TrainStep
    from .utils.precision import resolve_compute_dtype
    if isinstance(cfg, str):
        cfg = load_model_cfg(cfg)
    model = build_detector(cfg['model'], device, seed).train()
    optimizer = build_optimizer(model, cfg['optimizer'],
                                model.frozen_param_patterns())
    lr_cfg = cfg.get('lr_config') or {}
    scheduler = step_lr_schedule(
        cfg['optimizer']['lr'], steps_per_epoch, lr_cfg.get('step', []),
        warmup=lr_cfg.get('warmup'),
        warmup_iters=lr_cfg.get('warmup_iters', 500),
        warmup_ratio=lr_cfg.get('warmup_ratio', 1.0 / 3))
    clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    step = TrainStep(model, optimizer, scheduler,
                     clip['max_norm'] if clip else None,
                     compute_dtype=resolve_compute_dtype(cfg),
                     preprocess=preprocess)
    return model, optimizer, step


def tiny_demf_model_cfg():
    """Scaled-down DeMF for CPU runs (same topology, small dims), equal to
    ``demf_tpu.zoo.tiny_demf_model_cfg`` (a test holds the two together)."""
    return dict(
        type='DeMFVoteNet',
        img_backbone=dict(type='ResNet', depth=50, num_stages=4,
                          out_indices=(1, 2, 3), frozen_stages=1,
                          norm_eval=True, style='pytorch'),
        img_neck=dict(type='ChannelMapper', in_channels=[512, 1024, 2048],
                      kernel_size=1, out_channels=32, act_cfg=None,
                      norm_cfg=dict(type='GN', num_groups=8), num_outs=4),
        img_encoder=dict(
            type='DeformableDetrEncoder',
            encoder=dict(
                type='DetrTransformerEncoder', num_layers=2,
                transformerlayers=dict(
                    type='BaseTransformerLayer',
                    attn_cfgs=dict(type='MultiScaleDeformableAttention',
                                   embed_dims=32),
                    feedforward_channels=64, ffn_dropout=0.1,
                    operation_order=('self_attn', 'norm', 'ffn', 'norm'))),
            positional_encoding=dict(type='SinePositionalEncoding',
                                     num_feats=16, normalize=True,
                                     offset=-0.5),
            num_feature_levels=4, embed_dims=32),
        pts_backbone=dict(
            type='PointNet2SASSG', in_channels=4,
            num_points=(64, 32, 16, 8), radius=(0.2, 0.4, 0.8, 1.2),
            num_samples=(8, 8, 4, 4),
            sa_channels=((16, 16, 32), (32, 32, 32), (32, 32, 32),
                         (32, 32, 32)),
            fp_channels=((32, 32), (32, 32)), norm_cfg=dict(type='BN2d'),
            sa_cfg=dict(type='PointSAModule', pool_mod='max', use_xyz=True,
                        normalize_xyz=True)),
        pts_bbox_head=dict(
            type='DeMFVoteHead', num_classes=10,
            pred_layer_cfg=dict(in_channels=32,
                                shared_conv_channels=(32, 32), bias=True,
                                conv_pred_layers=2),
            decoder=dict(
                type='DeMFTransformerDecoderLayer', num_layers=1,
                transformerlayers=dict(
                    type='DetrTransformerDecoderLayer',
                    attn_cfgs=[
                        dict(type='MultiheadAttention', embed_dims=32,
                             num_heads=4, dropout=0.4),
                        dict(type='MultiScaleDeformableAttention',
                             num_heads=4, num_levels=4, num_points=2,
                             dropout=0.4, embed_dims=32)],
                    feedforward_channels=64, ffn_dropout=0.1,
                    operation_order=('self_attn', 'norm', 'cross_attn',
                                     'norm', 'ffn', 'norm')),
                posembed=dict(input_channel=6, num_pos_feats=32)),
            bbox_coder=dict(type='DeMFClassAgnosticBBoxCoder',
                            num_dir_bins=12, with_rot=True, num_sizes=10),
            objectness_loss=dict(type='CrossEntropyLoss',
                                 class_weight=[0.2, 0.8], reduction='sum',
                                 loss_weight=5.0),
            dir_class_loss=dict(type='CrossEntropyLoss', reduction='sum',
                                loss_weight=1.0),
            dir_res_loss=dict(type='SmoothL1Loss', reduction='sum',
                              loss_weight=10.0),
            size_res_loss=dict(type='SmoothL1Loss', reduction='sum',
                               loss_weight=10.0, beta=0.0625),
            center_loss=dict(type='SmoothL1Loss', beta=1.0 / 9.0,
                             reduction='sum', loss_weight=10.0),
            iou_loss=dict(type='AxisAlignedIoULoss', reduction='sum',
                          loss_weight=4.0),
            semantic_loss=dict(type='CrossEntropyLoss', reduction='sum',
                               loss_weight=1.0),
            vote_module_cfg=dict(
                in_channels=32, vote_per_seed=1, gt_per_seed=3,
                conv_channels=(32, 32), norm_feats=True,
                vote_loss=dict(type='ChamferDistance', mode='l1',
                               reduction='none', loss_dst_weight=10.0)),
            vote_aggregation_cfg=dict(
                type='PointSAModule', num_point=16, radius=0.3,
                num_sample=4, mlp_channels=[32, 32, 32, 32], use_xyz=True,
                normalize_xyz=True)),
        num_sampled_seed=1024,
        freeze_img_branch=True,
        train_cfg=dict(pts=dict(pos_distance_thr=0.3, neg_distance_thr=0.6,
                                sample_mod='seed')),
        test_cfg=dict(img_rcnn=dict(score_thr=0.1),
                      pts=dict(ensemble_layers=[0, 1], sample_mod='seed',
                               nms_thr=0.25, score_thr=0.05,
                               per_class_proposal=True)))


def tiny_detr_model_cfg():
    """Scaled-down stage-1 Deformable-DETR pretrain model for CPU runs: the
    model of ``configs/synthetic/detr_pretrain_tiny.py`` (ResNet-50 at full
    width, a 32-wide neck and head, 20 queries, 1 encoder and 2 decoder
    layers; a test holds the two together)."""
    def msda():
        return dict(type='MultiScaleDeformableAttention', embed_dims=32)

    return dict(
        type='ImVoteNet_Deformdetr',
        img_backbone=dict(type='ResNet', depth=50, num_stages=4,
                          out_indices=(1, 2, 3), frozen_stages=1,
                          norm_eval=True, style='pytorch'),
        img_neck=dict(type='ChannelMapper', in_channels=[512, 1024, 2048],
                      kernel_size=1, out_channels=32, act_cfg=None,
                      norm_cfg=dict(type='GN', num_groups=8), num_outs=4),
        img_bbox_head=dict(
            type='DeformableDETRHead', num_query=20, num_classes=10,
            in_channels=2048, sync_cls_avg_factor=True, as_two_stage=False,
            embed_dims=32,
            transformer=dict(
                type='DeformableDetrTransformer',
                encoder=dict(
                    type='DetrTransformerEncoder', num_layers=1,
                    transformerlayers=dict(
                        type='BaseTransformerLayer', attn_cfgs=msda(),
                        feedforward_channels=64, ffn_dropout=0.1,
                        operation_order=('self_attn', 'norm', 'ffn',
                                         'norm'))),
                decoder=dict(
                    type='DeformableDetrTransformerDecoder', num_layers=2,
                    return_intermediate=True,
                    transformerlayers=dict(
                        type='DetrTransformerDecoderLayer',
                        attn_cfgs=[
                            dict(type='MultiheadAttention', embed_dims=32,
                                 num_heads=4, dropout=0.1),
                            msda()],
                        feedforward_channels=64, ffn_dropout=0.1,
                        operation_order=('self_attn', 'norm', 'cross_attn',
                                         'norm', 'ffn', 'norm')))),
            positional_encoding=dict(type='SinePositionalEncoding',
                                     num_feats=16, normalize=True,
                                     offset=-0.5),
            loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=2.0,
                          alpha=0.25, loss_weight=2.0),
            loss_bbox=dict(type='L1Loss', loss_weight=5.0),
            loss_iou=dict(type='GIoULoss', loss_weight=2.0)),
        train_cfg=dict(
            assigner=dict(
                type='HungarianAssigner',
                cls_cost=dict(type='FocalLossCost', weight=2.0),
                reg_cost=dict(type='BBoxL1Cost', weight=5.0,
                              box_format='xywh'),
                iou_cost=dict(type='IoUCost', iou_mode='giou', weight=2.0))),
        test_cfg=dict(max_per_img=20))


def synth_detr2d_batch(b, hw=(800, 1344), g=20, seed=0):
    """Synthetic image-only batch of the stage-1 DETR pretrain (numpy), value
    for value ``demf_tpu.zoo.synth_detr2d_batch``: an image, ``g`` GT slots
    of xyxy boxes in pixels with labels, about 80% of them valid."""
    rng = np.random.RandomState(seed)
    h, w = hw
    boxes = np.zeros((b, g, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, w / 2, (b, g))
    boxes[..., 1] = rng.uniform(0, h / 2, (b, g))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(16, w / 2, (b, g))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(16, h / 2, (b, g))
    return dict(
        img=rng.rand(b, h, w, 3).astype(np.float32),
        img_meta=dict(img_shape=np.tile(np.array([list(hw)], np.int32),
                                        (b, 1))),
        gt_bboxes=boxes, gt_labels=rng.randint(0, 10, (b, g)),
        gt_bboxes_valid=rng.rand(b, g) < 0.8)


def tiny_imvotenet_model_cfg():
    """The ImVoteNet baseline of ``configs/baseline/imvotenet.py`` scaled
    down for CPU runs: ResNet-50 at full width and the real RPN / RoI
    wiring, a 16-wide FPN, RPN and 32-wide Shared2FC, a small point branch
    and towers, 32 seeds, a small proposal budget.  Equal to the JAX tests'
    ``tests/test_rpn_roi.py::tiny_imvotenet_cfg`` (a test holds the two
    together)."""
    m = copy.deepcopy(dict(load_model_cfg('baseline/imvotenet.py').model))
    m['img_neck'] = dict(type='FPN', in_channels=[256, 512, 1024, 2048],
                         out_channels=16, num_outs=5)
    m['img_rpn_head'] = dict(m['img_rpn_head'], in_channels=16,
                             feat_channels=16)
    roi = dict(m['img_roi_head'])
    roi['bbox_head'] = dict(roi['bbox_head'], in_channels=16,
                            fc_out_channels=32)
    m['img_roi_head'] = roi
    m['pts_backbone'] = dict(
        type='PointNet2SASSG', in_channels=4, num_points=(64, 32, 16, 8),
        radius=(0.2, 0.4, 0.8, 1.2), num_samples=(8, 8, 4, 4),
        sa_channels=((16, 16, 16), (16, 16, 16), (16, 16, 16), (16, 16, 16)),
        fp_channels=((16, 16), (16, 16)), norm_cfg=dict(type='BN2d'),
        sa_cfg=dict(type='PointSAModule', pool_mod='max', use_xyz=True,
                    normalize_xyz=True))
    heads = dict(m['pts_bbox_heads'])
    heads['common'] = dict(heads['common'], pred_layer_cfg=dict(
        in_channels=16, shared_conv_channels=(16, 16), bias=True))

    def tower(in_ch):
        return dict(
            vote_module_cfg=dict(
                in_channels=in_ch, vote_per_seed=1, gt_per_seed=3,
                conv_channels=(in_ch, in_ch), norm_feats=True,
                vote_loss=dict(type='ChamferDistance', mode='l1',
                               reduction='none', loss_dst_weight=10.0)),
            vote_aggregation_cfg=dict(
                type='PointSAModule', num_point=8, radius=0.3, num_sample=4,
                mlp_channels=[in_ch, 16, 16, 16], use_xyz=True,
                normalize_xyz=True))

    heads['joint'] = tower(32)
    heads['pts'] = tower(16)
    heads['img'] = tower(16)
    m['pts_bbox_heads'] = heads
    m['img_mlp'] = dict(in_channel=18, conv_channels=(16, 16))
    m['num_sampled_seed'] = 32
    tc = dict(m['test_cfg'])
    tc['img_rpn'] = dict(tc['img_rpn'], nms_pre=32, max_per_img=16)
    tc['img_rcnn'] = dict(tc['img_rcnn'], max_per_img=8)
    m['test_cfg'] = tc
    return m


def tiny_frcnn_model_cfg():
    """The image-only Faster R-CNN of ``tiny_imvotenet_model_cfg`` for CPU
    runs: its 2D branch at the same widths (so that its checkpoint warm-
    starts the tiny ImVoteNet), no point branch, trained, with the small
    proposal and sampler budgets of the JAX package's
    ``tests/test_rpn_roi.py::test_frcnn_image_only_training`` (a test holds
    the two together)."""
    m = tiny_imvotenet_model_cfg()
    for key in ('pts_backbone', 'pts_bbox_heads', 'img_mlp', 'fusion_layer',
                'num_sampled_seed'):
        m.pop(key)
    m['freeze_img_branch'] = False
    tc = dict(m['train_cfg'])
    tc.pop('pts')
    tc['img_rpn_proposal'] = dict(nms_pre=16, max_per_img=16,
                                  nms=dict(type='nms', iou_threshold=0.7))
    tc['img_rcnn'] = dict(
        assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                      neg_iou_thr=0.5, min_pos_iou=0.5,
                      match_low_quality=False),
        sampler=dict(type='RandomSampler', num=16, pos_fraction=0.25))
    tc['img_rpn'] = dict(
        assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.7,
                      neg_iou_thr=0.3, min_pos_iou=0.3,
                      match_low_quality=True),
        sampler=dict(type='RandomSampler', num=32, pos_fraction=0.5))
    m['train_cfg'] = tc
    m['test_cfg'] = dict(m['test_cfg'])
    m['test_cfg'].pop('pts')
    return m


def tiny_votenet_model_cfg():
    """The tiny VoteNet of ``configs/synthetic/votenet_tiny.py`` (the
    baseline's ``CAVoteHead`` at small widths), which the port reads as it
    is."""
    return copy.deepcopy(load_model_cfg('synthetic/votenet_tiny.py').model)


def synth_batch_for(model, b=None, p=20000, g=None, hw=None, seed=0):
    """The synthetic batch that ``model`` trains on (numpy), as its class
    names it (``synth_batch``: the batch maker, scenes, GT slots and the
    maker's other defaults; ``bench.py``'s sizes) unless given:
    ``synth_demf_batch`` of 16 scenes with 64 GT slots and 800x1344 images
    for DeMF-VoteNet, and the same at 608x832 (600x826 valid) for
    ImVoteNet; ``synth_points_batch`` of 16 scenes of ``p`` points with 64
    GT slots for VoteNet; ``synth_detr2d_batch`` of 4 images of 800x1344
    with 20 GT slots for the stage-1 pretrain, and of 16 images of 608x832
    with 64 for ImVoteNet's image-only Faster R-CNN; ``synth_fcaf3d_batch``
    of 8 scenes of ``p`` xyz + rgb points with 16 GT slots for FCAF3D, and
    the same with 800x1344 images for DeMF-FCAF3D."""
    spec = getattr(model, 'synth_batch', None)
    if spec is None:
        raise NotImplementedError(
            f'no synthetic batch for a {type(model).__name__}: DeMF-VoteNet, '
            f'ImVoteNet, VoteNet, the FCAF3D family and the stage-1 pretrain '
            f'model name theirs (synth_batch)')
    kind, scenes, slots = spec[:3]
    sizes = dict(dict(hw=(800, 1344)), **(spec[3] if len(spec) > 3 else {}))
    if hw is not None:
        sizes = dict(hw=tuple(hw))
    b, g = b or scenes, g or slots
    if kind == 'demf':
        return synth_demf_batch(b, p=p, g=g, seed=seed, **sizes)
    if kind == 'points':
        return synth_points_batch(b, p=p, g=g, seed=seed)
    if kind == 'fcaf3d':
        return synth_fcaf3d_batch(b, p=p, g=g, seed=seed)
    if kind == 'demf_fcaf3d':
        return synth_demf_fcaf3d_batch(b, p=p, g=g, seed=seed, **sizes)
    return synth_detr2d_batch(b, g=g, seed=seed, **sizes)


def synth_points_batch(b, p, g=32, seed=0):
    """Synthetic point-cloud batch (numpy), value for value
    ``demf_tpu.zoo.synth_points_batch``: ``p`` points of xyz + height in a
    6 m cube, ``g`` GT slots of rotated boxes with labels, about half of
    them valid."""
    rng = np.random.RandomState(seed)
    points = rng.rand(b, p, 4).astype(np.float32) * 6 - 3
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :3] = rng.rand(b, g, 3) * 4 - 2
    boxes[..., 3:6] = rng.rand(b, g, 3) * 1.2 + 0.3
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    return dict(points=points, gt_bboxes_3d=boxes,
                gt_labels_3d=rng.randint(0, 10, (b, g)),
                gt_valid=rng.rand(b, g) < 0.5)


def synth_demf_batch(b, p=20000, g=32, hw=(800, 1344), seed=0,
                     valid_hw=None):
    """Synthetic DeMF batch: ``synth_points_batch`` + image + calibration /
    aug meta, as numpy arrays (``engine.evaluation.batch_to_device`` moves
    it)."""
    rng = np.random.RandomState(seed)     # the points draw their own stream
    batch = synth_points_batch(b, p, g, seed)
    h, w = hw
    vh, vw = valid_hw or (h - 16, w - 32)
    k = np.array([[529.5, 0, vw / 2], [0, 529.5, vh / 2], [0, 0, 1]],
                 np.float32)
    d2i = np.eye(4, dtype=np.float32)
    d2i[:3, :3] = k @ _DEPTH2CAM
    meta = dict(
        img_shape=np.tile(np.array([[vh, vw]], np.int32), (b, 1)),
        scale_factor=np.ones((b, 2), np.float32),
        flip=np.zeros((b,), bool),
        depth2img=np.tile(d2i[None], (b, 1, 1)),
        pcd_rotation=np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
        pcd_scale_factor=np.ones((b,), np.float32),
        pcd_trans=np.zeros((b, 3), np.float32),
        pcd_horizontal_flip=np.zeros((b,), bool))
    return dict(batch, img=rng.rand(b, h, w, 3).astype(np.float32),
                img_meta=meta)


def synth_fcaf3d_batch(b, p=20000, g=16, seed=0):
    """Synthetic 6-dim (xyz + rgb) point batch of the FCAF3D family (numpy),
    value for value ``demf_tpu.zoo.synth_fcaf3d_batch``: points over a room
    of 6 x 6 x 2.8 m, ``g`` GT slots of rotated boxes, all valid."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, p, 6), np.float32)
    pts[..., 0] = rng.uniform(-3, 3, (b, p))
    pts[..., 1] = rng.uniform(0, 6, (b, p))
    pts[..., 2] = rng.uniform(-1.8, 1.0, (b, p))
    pts[..., 3:] = rng.rand(b, p, 3)
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :3] = rng.rand(b, g, 3) * 4 - 2
    boxes[..., 1] += 2.5
    boxes[..., 3:6] = rng.rand(b, g, 3) + 0.3
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    return dict(points=pts, gt_bboxes_3d=boxes,
                gt_labels_3d=rng.randint(0, 10, (b, g)),
                gt_valid=np.ones((b, g), bool))


def synth_demf_fcaf3d_batch(b, p=20000, g=16, hw=(800, 1344), seed=0,
                            valid_hw=None):
    """``synth_fcaf3d_batch`` with an image and the calibration / aug meta
    of ``synth_demf_batch`` (DeMF-FCAF3D's batch)."""
    demf = synth_demf_batch(b, p=8, g=1, hw=hw, seed=seed, valid_hw=valid_hw)
    return dict(synth_fcaf3d_batch(b, p, g, seed), img=demf['img'],
                img_meta=demf['img_meta'])
