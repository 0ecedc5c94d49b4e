# Tiny Deformable-DETR 2D pretrain (stage 1) on synthetic images, for the
# port's train entry on the CPU: configs/synthetic/detr_pretrain_tiny.py
# with its model taken from the port's zoo (a test holds the two files'
# contents together).
from demf_tpu_torch.zoo import tiny_detr_model_cfg

img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)

_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.0),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels']),
]

model = tiny_detr_model_cfg()

data = dict(
    samples_per_gpu=4,
    workers_per_gpu=1,
    train=dict(type='SyntheticSUNRGBD', num_scenes=8, num_raw_points=256,
               max_boxes=4, image_hw=(64, 96), pipeline=_pipeline, seed=11),
    val=dict(type='SyntheticSUNRGBD', num_scenes=4, num_raw_points=256,
             max_boxes=4, image_hw=(64, 96), pipeline=_pipeline, seed=12,
             test_mode=True),
    test=dict(type='SyntheticSUNRGBD', num_scenes=4, num_raw_points=256,
              max_boxes=4, image_hw=(64, 96), pipeline=_pipeline, seed=12,
              test_mode=True))

max_gt = 8
lr = 2e-4
optimizer = dict(
    type='AdamW', lr=lr, weight_decay=0.0001,
    paramwise_cfg=dict(custom_keys={
        'backbone': dict(lr_mult=0.1, decay_mult=1.0),
        'sampling_offsets': dict(lr_mult=0.1, decay_mult=1.0),
        'reference_points': dict(lr_mult=0.1, decay_mult=1.0)}))
optimizer_config = dict(grad_clip=dict(max_norm=0.1, norm_type=2))
lr_config = dict(policy='step', step=[7, 9])
runner = dict(type='EpochBasedRunner', max_epochs=1)
checkpoint_config = dict(interval=1)
log_config = dict(interval=1)
evaluation = dict(interval=0)
