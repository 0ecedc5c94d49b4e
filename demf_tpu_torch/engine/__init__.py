"""Engine of the port: inference and train steps, the epoch runner,
AdamW with the step schedule and optax's clip, the frozen-feature cache,
checkpoints, and weight transfer from the JAX package."""
from .checkpoint import (load_checkpoint, remap_img_branch_keys,
                         save_checkpoint)
from .evaluation import (batch_to_device, make_eval_step,
                         run_dataset_inference)
from .feature_cache import (FeatureCache, attach_cached_features,
                            compute_image_features)
from .optim import (build_optimizer, clip_grad_global_norm, global_norm,
                    set_lr, step_lr_schedule)
from .trainer import Runner, make_train_step
from .weights import state_dict_from_jax

__all__ = ['FeatureCache', 'Runner', 'attach_cached_features',
           'batch_to_device', 'build_optimizer', 'clip_grad_global_norm',
           'compute_image_features', 'global_norm', 'load_checkpoint',
           'make_eval_step', 'make_train_step', 'remap_img_branch_keys',
           'run_dataset_inference', 'save_checkpoint', 'set_lr',
           'state_dict_from_jax', 'step_lr_schedule']
