# The image-only Faster R-CNN of the ImVoteNet baseline at full width, the
# first stage of the published workflow (train the 2D detector, then warm-
# start stage 2 from it): the model of configs/_base_/models/
# imvotenet_image.py unchanged (caffe ResNet-50, FPN 256, RPN, Shared2FC
# 1024, the branch trained), the optimizer and schedule of
# configs/baseline/imvotenet.py, and a 2D train pipeline of its image steps
# (Resize (1333, 600) with keep_ratio, caffe Normalize, Pad 32) with
# RandomFlip at 0.5, on SyntheticSUNRGBD scenes of the real raw size (480x640
# images with 2D boxes) in place of the SUN RGB-D files.  Neither package
# computes a 2D mAP, so there is no evaluation.
import os

from demf_tpu_torch.utils.config import Config

_base_ = ['../../configs/_base_/models/imvotenet_image.py']
_full = Config.fromfile(os.path.join(os.path.dirname(__file__), '..', '..',
                                     'configs', 'baseline', 'imvotenet.py'))

img_norm_cfg = _full.img_norm_cfg
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(1333, 600), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect3D', keys=['img', 'gt_bboxes', 'gt_labels']),
]
_scenes = dict(type='SyntheticSUNRGBD', pipeline=train_pipeline)
data = dict(
    samples_per_gpu=16,
    workers_per_gpu=4,
    train=dict(_scenes, num_scenes=32, seed=0),
    val=dict(_scenes, num_scenes=16, seed=1),
    test=dict(_scenes, num_scenes=16, seed=1))

optimizer = _full.optimizer
optimizer_config = _full.optimizer_config
lr_config = _full.lr_config
runner = dict(type='EpochBasedRunner', max_epochs=1)
checkpoint_config = dict(interval=1)
log_config = dict(interval=1)
evaluation = dict(interval=0)
max_gt = 64
del _full
