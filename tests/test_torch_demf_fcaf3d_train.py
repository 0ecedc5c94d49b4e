"""DeMF-FCAF3D trained by the port (``models/demf_fcaf3d.py``: FCAF3D's
loss on the levels and the fusion stage's on the selected voxels, over the
N + 1 stages) against the JAX package's, on the CPU.

* one train step of ``configs/synthetic/demf_fcaf3d_tiny.py`` (every
  dropout rate 0, 3 cm voxels as ``test_torch_fcaf3d_train.py`` runs
  FCAF3D) from the frozen image branch's cached features, on the same
  weights and scenes: the JAX side's ``jax.value_and_grad`` of
  ``model.apply(train=True)`` + ``model.loss`` (MSDA in float32,
  ``DEMF_TPU_MSDA_F32=1``), the port's ``zoo.build_trainer`` step.  Every
  loss key (the fusion stage's ``.f0`` ones too) and the gradient norm
  within 1e-4 relative, each gradient within 1e-3 of its tensor's
  largest, the BatchNorm running statistics within 1e-5 relative; the
  image branch frozen, in eval mode, unchanged by the step;
* the train entry in dataset mode fills the feature cache, trains from it
  and writes a checkpoint.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.engine.torch_port import unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import train as train_entry
from demf_tpu_torch import zoo
from test_torch_fcaf3d import jax_variables
from test_torch_fcaf3d_train import (check_batch_stats, check_grads,
                                     check_losses, jax_train_step,
                                     port_train_step, tiny_train_cfg,
                                     train_batch)

IMG_BRANCH = ('img_backbone', 'img_neck', 'img_encoder')


def no_dropout(cfg):
    head = dict(cfg['head'])
    dec = dict(head['decoder'])
    tl = dict(dec['transformerlayers'], ffn_dropout=0.0)
    tl['attn_cfgs'] = [dict(c, dropout=0.0) for c in tl['attn_cfgs']]
    dec['transformerlayers'] = tl
    head['decoder'] = dec
    return dict(cfg, head=head)


@pytest.fixture(scope='module')
def step_pair():
    """(JAX step, the port's model after its step, its metrics, the full
    config, the image branch's parameters before the step)."""
    full, cfg = tiny_train_cfg('synthetic/demf_fcaf3d_tiny.py')
    cfg = no_dropout(cfg)
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = train_batch(zoo.synth_demf_fcaf3d_batch, b=2, p=512, g=4,
                        hw=(64, 96), valid_hw=(60, 90), seed=0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = jax_variables(jmodel, jbatch)
    jp, js = unflatten_params(params), unflatten_params(stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        levels = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False, img_feat_only=True))(
                {'params': jp, 'batch_stats': js}, jbatch))
        cached = {k: v for k, v in batch.items() if k != 'img'}
        cached['img_features'] = tuple(np.asarray(f) for f in levels)
        jax_out = jax_train_step(jmodel, jp, js, jax.tree_util.tree_map(
            jnp.asarray, cached))
    from demf_tpu_torch.engine.weights import state_dict_from_jax
    before = {k: v for k, v in state_dict_from_jax(params, stats).items()
              if k.startswith(IMG_BRANCH) and v.is_floating_point()}
    model, metrics = port_train_step(cfg, full, params, stats, cached)
    return jax_out, model, metrics, full, before


def test_train_step_losses_match_jax(step_pair):
    jax_out, _, metrics, _, _ = step_pair
    assert {'loss_cls.f0', 'loss_centerness.f0',
            'loss_bbox.f0'} <= set(metrics)
    check_losses(jax_out, metrics)


def test_train_step_grads_match_jax(step_pair):
    jax_out, model, _, full, _ = step_pair
    max_norm = full.optimizer_config['grad_clip']['max_norm']
    assert check_grads(jax_out, model, max_norm, IMG_BRANCH) > 60


def test_train_step_batch_stats_match_jax(step_pair):
    assert check_batch_stats(step_pair[0], step_pair[1]) > 40


def test_train_step_keeps_the_image_branch_frozen(step_pair):
    """The frozen branch stays in eval mode while the detector trains
    (its BatchNorms keep their statistics) and no step changes it."""
    model, before = step_pair[1], step_pair[4]
    assert model.training and model.head.training
    for name in IMG_BRANCH:
        module = getattr(model, name)
        assert not any(m.training for m in module.modules()), name
    state = model.state_dict()
    assert before
    for key, value in before.items():
        assert torch.equal(state[key], value), key
    for name, p in model.named_parameters():
        assert p.requires_grad == (not name.startswith(IMG_BRANCH)), name


def test_train_entry_dataset_mode_uses_the_feature_cache(tmp_path, capsys):
    train_entry.main(['configs/synthetic/demf_fcaf3d_tiny.py', '--device',
                      'cpu', '--work-dir', str(tmp_path)])
    out = capsys.readouterr().out
    assert 'image-feature cache active' in out
    assert 'training finished' in out
    assert os.listdir(tmp_path / 'img_feat_cache')
    ckpt = torch.load(tmp_path / 'checkpoints' / 'epoch_1.pth',
                      weights_only=False)
    assert all(torch.isfinite(v).all() for v in ckpt['state_dict'].values()
               if v.is_floating_point())
