# Tiny ImVoteNet on synthetic RGB-D scenes for the port's entry points on
# the CPU: the Faster R-CNN 2D branch (ResNet-50 at full width, a 16-wide
# FPN / RPN / RoI head), VoteFusion and the three towers at small widths
# (zoo.tiny_imvotenet_model_cfg), the baseline's caffe image normalization
# and pipeline order at a 64x96 image and 128 points.
from demf_tpu_torch.zoo import tiny_imvotenet_model_cfg

model = tiny_imvotenet_model_cfg()
# random tiny weights score every 2D box near 1 / 11: keep them all
model['test_cfg']['img_rcnn']['score_thr'] = 0.05

class_names = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk', 'dresser',
               'night_stand', 'bookshelf', 'bathtub')
img_norm_cfg = dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0],
                    to_rgb=False)

train_pipeline = [
    dict(type='LoadPointsFromFile', coord_type='DEPTH', shift_height=True,
         load_dim=6, use_dim=[0, 1, 2]),
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations3D'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.0),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='RandomFlip3D', sync_2d=False, flip_ratio_bev_horizontal=0.5),
    dict(type='GlobalRotScaleTrans', rot_range=[-0.523599, 0.523599],
         scale_ratio_range=[0.85, 1.15], shift_height=True),
    dict(type='PointSample', num_points=128),
    dict(type='DefaultFormatBundle3D', class_names=class_names),
    dict(type='Collect3D', keys=['img', 'gt_bboxes', 'gt_labels', 'points',
                                 'gt_bboxes_3d', 'gt_labels_3d']),
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadPointsFromFile', coord_type='DEPTH', shift_height=True,
         load_dim=6, use_dim=[0, 1, 2]),
    dict(type='MultiScaleFlipAug3D', img_scale=(96, 64), pts_scale_ratio=1,
         flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='RandomFlip', flip_ratio=0.0),
             dict(type='Normalize', **img_norm_cfg),
             dict(type='Pad', size_divisor=32),
             dict(type='GlobalRotScaleTrans', rot_range=[0, 0],
                  scale_ratio_range=[1., 1.], translation_std=[0, 0, 0]),
             dict(type='RandomFlip3D', sync_2d=False,
                  flip_ratio_bev_horizontal=0.5),
             dict(type='PointSample', num_points=128),
             dict(type='DefaultFormatBundle3D', class_names=class_names,
                  with_label=False),
             dict(type='Collect3D', keys=['img', 'points']),
         ]),
]

_scenes = dict(type='SyntheticSUNRGBD', num_raw_points=256, max_boxes=4,
               image_hw=(64, 96))
data = dict(
    samples_per_gpu=4,
    workers_per_gpu=1,
    train=dict(_scenes, num_scenes=8, pipeline=train_pipeline, seed=21),
    val=dict(_scenes, num_scenes=4, pipeline=test_pipeline, seed=22,
             test_mode=True),
    test=dict(_scenes, num_scenes=4, pipeline=test_pipeline, seed=22,
              test_mode=True))

max_gt = 8
lr = 0.008
optimizer = dict(type='AdamW', lr=lr, weight_decay=0.01)
optimizer_config = dict(grad_clip=dict(max_norm=10, norm_type=2))
lr_config = dict(policy='step', warmup=None, step=[2])
runner = dict(type='EpochBasedRunner', max_epochs=1)
checkpoint_config = dict(interval=1, max_keep_ckpts=1)
log_config = dict(interval=1)
evaluation = dict(interval=1)
