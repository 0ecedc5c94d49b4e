# Tiny DeMF on synthetic RGB-D scenes for the port's entry points on the
# CPU: the full fusion pipeline + the frozen image-feature cache.  The data,
# schedule and checkpoint sections of configs/synthetic/demf_tiny.py (which
# imports the JAX package's zoo and so cannot be read by the port).
from demf_tpu_torch.zoo import tiny_demf_model_cfg

model = tiny_demf_model_cfg()

class_names = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk', 'dresser',
               'night_stand', 'bookshelf', 'bathtub')
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)

_pipeline = [
    dict(type='LoadPointsFromFile', coord_type='DEPTH', shift_height=True,
         load_dim=6, use_dim=[0, 1, 2]),
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations3D'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.0),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='PointSample', num_points=128),
    dict(type='DefaultFormatBundle3D', class_names=class_names),
    dict(type='Collect3D', keys=['img', 'gt_bboxes', 'gt_labels', 'points',
                                 'gt_bboxes_3d', 'gt_labels_3d']),
]

data = dict(
    samples_per_gpu=4,
    workers_per_gpu=1,
    train=dict(type='SyntheticSUNRGBD', num_scenes=8, num_raw_points=256,
               max_boxes=4, image_hw=(64, 96), pipeline=_pipeline, seed=21),
    val=dict(type='SyntheticSUNRGBD', num_scenes=4, num_raw_points=256,
             max_boxes=4, image_hw=(64, 96), pipeline=_pipeline, seed=22,
             test_mode=True),
    test=dict(type='SyntheticSUNRGBD', num_scenes=4, num_raw_points=256,
              max_boxes=4, image_hw=(64, 96), pipeline=_pipeline, seed=22,
              test_mode=True))

max_gt = 8
cached_img_features = True
lr = 0.004
optimizer = dict(
    type='AdamW', lr=lr, weight_decay=0.01,
    paramwise_cfg=dict(custom_keys={
        'decoder': dict(lr_mult=0.05, decay_mult=1.0)}))
optimizer_config = dict(grad_clip=dict(max_norm=10, norm_type=2))
lr_config = dict(policy='step', warmup=None, step=[2])
runner = dict(type='EpochBasedRunner', max_epochs=1)
checkpoint_config = dict(interval=1, max_keep_ckpts=1)
log_config = dict(interval=1)
evaluation = dict(interval=0)
