# The image-only Faster R-CNN of the ImVoteNet baseline, tiny, for the
# port's train entry on the CPU: the 2D branch of zoo.tiny_imvotenet_model_
# cfg (ResNet-50 at full width, a 16-wide FPN and RPN, a 32-wide Shared2FC)
# without the point branch, trained; 64x96 images and the small proposal
# and sampler budgets of the JAX package's tests/test_rpn_roi.py.  Its
# checkpoint warm-starts demf_tpu_torch/configs/imvotenet_tiny.py
# (load_from), as the published workflow's stage 1 does stage 2.
from demf_tpu_torch.zoo import tiny_frcnn_model_cfg

model = tiny_frcnn_model_cfg()

img_norm_cfg = dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0],
                    to_rgb=False)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True),
    dict(type='Resize', img_scale=(96, 64), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
    dict(type='Collect3D', keys=['img', 'gt_bboxes', 'gt_labels']),
]
_scenes = dict(type='SyntheticSUNRGBD', num_raw_points=256, max_boxes=4,
               image_hw=(64, 96), pipeline=train_pipeline)
data = dict(
    samples_per_gpu=4,
    workers_per_gpu=1,
    train=dict(_scenes, num_scenes=8, seed=31),
    val=dict(_scenes, num_scenes=4, seed=32),
    test=dict(_scenes, num_scenes=4, seed=32))

max_gt = 8
optimizer = dict(type='AdamW', lr=0.008, weight_decay=0.01)
optimizer_config = dict(grad_clip=dict(max_norm=10, norm_type=2))
lr_config = dict(policy='step', warmup=None, step=[2])
runner = dict(type='EpochBasedRunner', max_epochs=1)
checkpoint_config = dict(interval=1, max_keep_ckpts=1)
log_config = dict(interval=1)
evaluation = dict(interval=0)
