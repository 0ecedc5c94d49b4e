"""The port's own registries: string keys resolving ``dict(type='Name',
...)`` configs, as mmcv's registries do.

``Registry`` and ``build_from_cfg`` are the port's copy of
``demf_tpu/utils/registry.py`` (standard library only): the port imports
nothing of the JAX package.  The instances are the port's own too, since
both packages register the same class names.
"""
from __future__ import annotations

import collections.abc
import inspect


class Registry:
    def __init__(self, name):
        self.name = name
        self._module_dict = {}

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f'Registry({self.name}, items={list(self._module_dict)})'

    def get(self, key):
        return self._module_dict.get(key)

    def register_module(self, name=None, module=None, force=False):
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module, name=None, force=False):
        if name is None:
            name = module.__name__
        names = [name] if isinstance(name, str) else list(name)
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f'{n} already registered in {self.name}')
            self._module_dict[n] = module

    def build(self, cfg, default_args=None):
        return build_from_cfg(cfg, self, default_args)


def build_from_cfg(cfg, registry, default_args=None):
    """Instantiate ``registry[cfg['type']](**cfg_without_type)``."""
    if cfg is None:
        return None
    if not isinstance(cfg, collections.abc.Mapping):
        raise TypeError(f'cfg must be a dict, got {type(cfg)}')
    if 'type' not in cfg:
        raise KeyError(f'cfg must contain the key "type": {cfg}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not registered in {registry.name}; '
                           f'available: {sorted(registry._module_dict)}')
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be str or class, got {type(obj_type)}')
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)


DETECTORS = Registry('torch_detectors')
BACKBONES = Registry('torch_backbones')
NECKS = Registry('torch_necks')
HEADS = Registry('torch_heads')
BBOX_CODERS = Registry('torch_bbox_coders')
LOSSES = Registry('torch_losses')
PIPELINES = Registry('torch_pipelines')
DATASETS = Registry('torch_datasets')

__all__ = ['BACKBONES', 'BBOX_CODERS', 'DATASETS', 'DETECTORS', 'HEADS',
           'LOSSES', 'NECKS', 'PIPELINES', 'Registry', 'build_from_cfg']
