# The stage-1 Deformable-DETR pretrain at full width
# (configs/deformdetr/imvotenet_deform.py: model, optimizer, schedule and
# the 2D train pipeline with its AutoAugment, RandomCrop and multi-scale
# Resize unchanged) on SyntheticSUNRGBD scenes of the real raw size (480x640
# images with 2D boxes) in place of the SUN RGB-D files: what the port's
# train entry runs where no dataset is at hand.  Neither package computes a
# 2D mAP, so there is no evaluation.
import os

from demf_tpu_torch.utils.config import Config

_base_ = ['../../configs/deformdetr/imvotenet_deform.py']
_full = Config.fromfile(os.path.join(os.path.dirname(__file__), _base_[0]))

data = dict(
    samples_per_gpu=4,
    train=dict(_delete_=True, type='SyntheticSUNRGBD', num_scenes=16, seed=0,
               pipeline=_full.train_pipeline),
    val=dict(_delete_=True, type='SyntheticSUNRGBD', num_scenes=4, seed=1,
             test_mode=True, pipeline=_full.test_pipeline),
    test=dict(_delete_=True, type='SyntheticSUNRGBD', num_scenes=4, seed=1,
              test_mode=True, pipeline=_full.test_pipeline))
del _full

max_gt = 20
runner = dict(type='EpochBasedRunner', max_epochs=1)
log_config = dict(interval=1)
evaluation = dict(interval=0)
