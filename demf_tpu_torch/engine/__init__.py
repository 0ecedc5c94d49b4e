"""Engine of the port: inference and train steps, the epoch runner with
its eval hook, the dataset evaluation loop, AdamW / Adam / SGD with the
step schedule and optax's clip, the frozen-feature cache, checkpoints, the
entry points' argument parsers (``cli``), weight transfer from the JAX
package, and the eval extras: ``fuse_bn``, ``visualize`` and the flip
aug-test ``aug_test``."""
from .checkpoint import (latest_checkpoint, load_checkpoint, load_meta,
                         load_weights, remap_img_branch_keys,
                         save_checkpoint)
from .evaluation import (batch_to_device, make_dataset_eval_fn,
                         make_eval_step, run_batches_inference,
                         run_dataset_inference)
from .feature_cache import (CachedFeatureLoader, FeatureCache,
                            attach_cached_features, compute_image_features,
                            precompute_dataset_features)
from .optim import (build_optimizer, clip_grad_global_norm, global_norm,
                    set_lr, step_lr_schedule)
from .trainer import Runner, TrainStep
from .weights import state_dict_from_jax

__all__ = ['CachedFeatureLoader', 'FeatureCache', 'Runner', 'TrainStep',
           'attach_cached_features', 'batch_to_device', 'build_optimizer',
           'clip_grad_global_norm', 'compute_image_features', 'global_norm',
           'latest_checkpoint', 'load_checkpoint', 'load_meta',
           'load_weights', 'make_dataset_eval_fn', 'make_eval_step',
           'precompute_dataset_features',
           'remap_img_branch_keys', 'run_batches_inference',
           'run_dataset_inference', 'save_checkpoint', 'set_lr',
           'state_dict_from_jax', 'step_lr_schedule']
