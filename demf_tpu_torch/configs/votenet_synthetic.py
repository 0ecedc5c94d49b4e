# VoteNet at full width (configs/baseline/votenet.py: model, optimizer,
# schedule and both pipelines unchanged) on SyntheticSUNRGBD scenes of the
# real raw size (24,000 points) in place of the SUN RGB-D files: what the
# port's entry points run where no dataset is at hand.  Points only: no
# image, no feature cache.
import os

from demf_tpu_torch.utils.config import Config

_base_ = ['../../configs/baseline/votenet.py']
_full = Config.fromfile(os.path.join(os.path.dirname(__file__), _base_[0]))

data = dict(
    train=dict(_delete_=True, type='SyntheticSUNRGBD', num_scenes=32, seed=0,
               pipeline=_full.train_pipeline),
    val=dict(_delete_=True, type='SyntheticSUNRGBD', num_scenes=18, seed=1,
             test_mode=True, pipeline=_full.test_pipeline),
    test=dict(_delete_=True, type='SyntheticSUNRGBD', num_scenes=18, seed=1,
              test_mode=True, pipeline=_full.test_pipeline))
del _full

runner = dict(type='EpochBasedRunner', max_epochs=1)
log_config = dict(interval=1)
evaluation = dict(interval=1)
