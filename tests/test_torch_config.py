"""The port's own ``Config``, ``Registry`` / ``build_from_cfg`` and
``load_model_cfg`` against the JAX package's, from which they were copied,
on the shared ``configs/``; and the device defaults of ``zoo``'s build functions."""
import os

import pytest
import torch

from demf_tpu.utils import config as jconfig
from demf_tpu.utils import registry as jregistry
from demf_tpu.zoo import load_model_cfg as jload_model_cfg
from demf_tpu.zoo import tiny_demf_model_cfg
from demf_tpu_torch import registry, zoo
from demf_tpu_torch.utils import config

CONFIGS = ('demf/demf_votenet.py', 'baseline/votenet.py')


def plain(obj):
    """Nested ConfigDicts as plain dicts / lists (tuples kept)."""
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    return obj


@pytest.mark.parametrize('rel_path', CONFIGS)
def test_load_model_cfg_equals_jax_package(rel_path):
    got, want = zoo.load_model_cfg(rel_path), jload_model_cfg(rel_path)
    assert isinstance(got, config.Config)
    assert not isinstance(got, jconfig.Config)
    assert plain(dict(got.items())) == plain(dict(want.items()))
    assert got.pretty_text == want.pretty_text
    assert got.model.type == want.model.type
    assert os.path.samefile(got.filename, want.filename)


def test_config_base_inheritance_delete_and_overrides(tmp_path):
    """``_base_`` merge, ``_delete_`` and dot-path overrides, the same in
    both copies."""
    (tmp_path / 'base.py').write_text(
        "model = dict(type='A', neck=dict(k=1, c=2), head=dict(x=1))\n"
        "lr = 0.1\n")
    (tmp_path / 'child.py').write_text(
        "_base_ = ['./base.py']\n"
        "model = dict(neck=dict(c=3), head=dict(_delete_=True, y=2))\n")
    out = []
    for mod in (config, jconfig):
        cfg = mod.Config.fromfile(str(tmp_path / 'child.py'))
        cfg.merge_from_dict({'model.neck.k': 7})
        out.append(plain(dict(cfg.items())))
    assert out[0] == out[1]
    assert out[0]['model'] == dict(type='A', neck=dict(k=7, c=3),
                                   head=dict(y=2))
    assert out[0]['lr'] == 0.1


def test_registry_builds_and_refuses_a_second_registration():
    class Thing:
        def __init__(self, a, b=2):
            self.a, self.b = a, b

    for mod in (registry, jregistry):
        reg = mod.Registry('things')
        reg.register_module()(Thing)
        assert 'Thing' in reg and reg.get('Thing') is Thing
        with pytest.raises(KeyError, match='already registered'):
            reg.register_module()(Thing)
        reg.register_module(force=True)(Thing)
        built = mod.build_from_cfg(dict(type='Thing', a=1), reg,
                                   default_args=dict(b=5))
        assert (built.a, built.b) == (1, 5)
        assert reg.build(dict(type=Thing, a=3)).a == 3
        assert mod.build_from_cfg(None, reg) is None
        with pytest.raises(KeyError, match='not registered'):
            mod.build_from_cfg(dict(type='Other'), reg)
        with pytest.raises(KeyError, match='"type"'):
            mod.build_from_cfg(dict(a=1), reg)
        with pytest.raises(TypeError):
            mod.build_from_cfg([1], reg)


def test_port_registries_are_its_own():
    assert registry.Registry is not jregistry.Registry
    assert registry.DETECTORS is not jregistry.DETECTORS
    import demf_tpu_torch.models  # noqa: F401  (registers the port's classes)
    assert 'DeMFVoteNet' in registry.DETECTORS
    assert registry.DETECTORS.get('DeMFVoteNet').__module__.startswith(
        'demf_tpu_torch.')


@pytest.mark.parametrize('build', ['build_detector', 'build_trainer'])
def test_build_defaults_to_the_card_and_raises_without_one(build):
    """With no device passed ``zoo`` builds on the card; where there is
    none they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default builds on it')
    cfg = tiny_demf_model_cfg()
    if build == 'build_trainer':
        cfg = dict(model=cfg, optimizer=dict(type='AdamW', lr=1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(zoo, build)(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(zoo, build)(cfg, 'cuda')


def test_build_detector_on_the_cpu_when_asked():
    model = zoo.build_detector(tiny_demf_model_cfg(), 'cpu')
    assert next(model.parameters()).device.type == 'cpu'
    assert not model.training
