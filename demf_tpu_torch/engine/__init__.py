"""Inference step and weight transfer of the port."""
from .evaluation import (batch_to_device, make_eval_step,
                         run_dataset_inference)
from .weights import state_dict_from_jax

__all__ = ['batch_to_device', 'make_eval_step', 'run_dataset_inference',
           'state_dict_from_jax']
