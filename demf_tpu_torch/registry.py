"""The port's own registries.

The ``Registry`` class comes from ``demf_tpu.utils.registry`` (numpy and
stdlib only); the instances are new, because the JAX package's global
registries already hold the same class names.
"""
from demf_tpu.utils.registry import Registry, build_from_cfg

DETECTORS = Registry('torch_detectors')
BACKBONES = Registry('torch_backbones')
NECKS = Registry('torch_necks')
HEADS = Registry('torch_heads')
BBOX_CODERS = Registry('torch_bbox_coders')
LOSSES = Registry('torch_losses')

__all__ = ['BACKBONES', 'BBOX_CODERS', 'DETECTORS', 'HEADS', 'LOSSES',
           'NECKS', 'Registry', 'build_from_cfg']
