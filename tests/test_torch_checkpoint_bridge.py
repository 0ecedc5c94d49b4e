"""Checkpoints across the packages (ROADMAP M9), on the CPU.

* A JAX checkpoint (orbax, with its ``.meta.json``) of the tiny
  DeMF-VoteNet and of the tiny ImVoteNet, weights made on the JAX side and
  saved with ``demf_tpu.engine.checkpoint.save_checkpoint``, goes through
  ``convert_jax_checkpoint.py``; the ``.pth`` loads strictly into the port
  and gives the JAX model's eval detections: DeMF through ``python -m
  demf_tpu_torch.eval`` against the JAX package's dataset inference,
  ImVoteNet through its forward and ``get_bboxes`` on the same seed draws;
  the tiny FCAF3D's ``.pth`` holds ``state_dict_from_jax``'s tensors, loads
  strictly and serves through ``python -m demf_tpu_torch.eval``.  The
  converter takes an FCAF3D config; training one is refused by name.
* A released mmcv-format file (``state_dict``, ``meta`` with ``epoch``,
  ``iter``, ``CLASSES`` as a tuple, ``mmcv_version``, the config's text,
  and mmcv's optimizer state) runs through ``python -m
  demf_tpu_torch.eval --device cpu``, takes its ``CLASSES`` and gives the
  same detections as the port's own checkpoint of the same weights; it
  warm-starts through ``load_from``; its epoch reads as ``meta['epoch'] -
  1``, the port's count; a resume from it is refused, and so is a file
  that needs a global a ``weights_only`` load does not take, by its name.
"""
import argparse
import importlib.util
import os
import pickle
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu import data as jdata
from demf_tpu.engine import checkpoint as jcheckpoint
from demf_tpu.engine import evaluation as jevaluation
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import eval as eval_entry
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import (batch_to_device, load_checkpoint,
                                   load_meta, load_weights, save_checkpoint)
from demf_tpu_torch.engine.optim import build_optimizer
from demf_tpu_torch.utils.config import Config
from test_torch_imvotenet import fixed_draws, scene_batch, tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMF_CFG = os.path.join(ROOT, 'demf_tpu_torch', 'configs', 'demf_tiny.py')
IMVOTENET_CFG = os.path.join(ROOT, 'demf_tpu_torch', 'configs',
                             'imvotenet_tiny.py')
CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk', 'dresser',
           'night_stand', 'bookshelf', 'bathtub')


def converter():
    """The root-level script as a module."""
    spec = importlib.util.spec_from_file_location(
        'convert_jax_checkpoint', os.path.join(ROOT,
                                               'convert_jax_checkpoint.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def random_variables(jmodel, jbatch, seed):
    """Flat params and statistics of ``jmodel`` at its ``init`` shapes:
    kernels at fan-in scale, biases small, BatchNorm scales near 1 and
    statistics spread (no compile: ``jax.eval_shape``)."""
    shapes = jax.eval_shape(lambda r, b: jmodel.init(r, b, train=False),
                            {'params': jax.random.PRNGKey(0),
                             'sample': jax.random.PRNGKey(0)}, jbatch)
    rng = np.random.RandomState(seed)
    params = {}
    for k, s in flatten_params(shapes['params']).items():
        if k.endswith('kernel'):
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif k.endswith('scale'):
            v = 1.0 + rng.randn(*s.shape) * 0.02
        else:
            v = rng.randn(*s.shape) * 0.02
        params[k] = v.astype(np.float32)
    stats = {k: (rng.randn(*s.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, s.shape)).astype(np.float32)
             for k, s in flatten_params(shapes['batch_stats']).items()}
    return params, stats


def save_jax(work_dir, params, stats, epoch):
    """The JAX package's checkpoint of these variables, with its meta."""
    state = {'params': unflatten_params(params),
             'batch_stats': unflatten_params(stats)}
    jcheckpoint.save_checkpoint(work_dir, state, epoch,
                                meta=dict(CLASSES=list(CLASSES),
                                          config='(the test config)'))
    return jcheckpoint.latest_checkpoint(work_dir)


def test_demf_jax_checkpoint_serves_through_the_eval_entry(tmp_path,
                                                          capsys):
    cfg = Config.fromfile(DEMF_CFG)
    jmodel_cfg = zoo.tiny_demf_model_cfg()
    jmodel_cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    jmodel_cfg['pts_bbox_head']['vote_aggregation_cfg'][
        'ball_query_exact'] = True
    jmodel = build_from_cfg(jmodel_cfg, JAX_DETECTORS)
    jds = jdata.build_dataset(cfg.data['test'])
    np.random.seed(0)
    batch0 = jdata.collate_fixed([jds[0]], max_gt=cfg.max_gt)
    params, stats = random_variables(jmodel, batch0, seed=0)
    # box sizes around 1.5 m, so boxes hold points and NMS has work to do
    for i in range(2):
        params[f'pts_bbox_head/conv_pred{i}/conv_reg/bias'][3:6] += 1.5
    ckpt = save_jax(str(tmp_path / 'jax'), params, stats, epoch=2)
    out = str(tmp_path / 'demf.pth')
    converter().main([DEMF_CFG, ckpt, out])
    assert 'epoch 2, 10 classes' in capsys.readouterr().out
    payload = torch.load(out, weights_only=True)
    assert payload['epoch'] == 2 and payload['meta']['epoch'] == 2
    assert tuple(payload['meta']['CLASSES']) == CLASSES
    assert payload['meta']['converted_from'] == os.path.abspath(ckpt)
    assert 'optimizer' not in payload

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        np.random.seed(1)
        want = jevaluation.run_dataset_inference(
            jmodel, {'params': unflatten_params(params),
                     'batch_stats': unflatten_params(stats)}, jds,
            batch_size=cfg.data['samples_per_gpu'], max_gt=cfg.max_gt)
    results = str(tmp_path / 'results.pkl')
    np.random.seed(1)
    eval_entry.main([DEMF_CFG, out, '--device', 'cpu', '--out', results])
    assert "'epoch': 2" in capsys.readouterr().out
    with open(results, 'rb') as f:
        got = pickle.load(f)
    assert len(got) == len(want) == 4
    assert sum(len(w['scores_3d']) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['labels_3d'], w['labels_3d'])
        np.testing.assert_allclose(g['boxes_3d'], w['boxes_3d'], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(g['scores_3d'], w['scores_3d'], rtol=0,
                                   atol=1e-5)


def test_imvotenet_jax_checkpoint_gives_the_jax_detections(tmp_path):
    cfg = Config.fromfile(IMVOTENET_CFG)
    jmodel = build_from_cfg(tiny_cfg(), JAX_DETECTORS)
    batch = scene_batch(2)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    draws = {(2, 96): np.random.RandomState(9).rand(2, 96).astype(
        np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        fixed_draws(mp, draws)
        params, stats = random_variables(jmodel, jbatch, seed=1)

        @jax.jit
        def serve(p, b):
            results = jmodel.apply({'params': p, 'batch_stats':
                                    unflatten_params(stats)}, b, train=False)
            return jmodel.get_bboxes(results, b)

        want = jax.device_get(serve(unflatten_params(params), jbatch))
    ckpt = save_jax(str(tmp_path / 'jax'), params, stats, epoch=0)
    out = str(tmp_path / 'imvotenet.pth')
    converter().main([IMVOTENET_CFG, ckpt, out])
    model = zoo.build_detector(cfg.model, 'cpu')
    assert load_checkpoint(out, model) == 0
    with torch.no_grad():
        tbatch = batch_to_device(batch, 'cpu')
        results = model(tbatch, draws=dict(
            seeds=torch.from_numpy(draws[(2, 96)])))
        got = model.get_bboxes(results, tbatch)
    assert results['bboxes_2d_valid'].any()
    np.testing.assert_array_equal(got['valid'].numpy(), want['valid'])
    assert want['valid'].any()
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    for key in ('boxes_3d', 'scores_3d'):
        w = np.asarray(want[key])
        assert np.abs(got[key].numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_an_fcaf3d_config_is_refused_by_name(tmp_path):
    """The FCAF3D family is served (ROADMAP M8's first half): the converter
    takes its configs and goes on to read the checkpoint; what is refused
    by name is training it (M8's second half)."""
    with pytest.raises(FileNotFoundError):
        converter().convert(os.path.join(ROOT, 'configs', 'fcaf3d',
                                         'fcaf3d_sunrgbd.py'),
                            str(tmp_path / 'none'), str(tmp_path / 'x.pth'))
    with pytest.raises(NotImplementedError, match=r'ROADMAP M8'):
        zoo.build_trainer('fcaf3d/fcaf3d_sunrgbd.py', 'cpu')


def test_fcaf3d_jax_checkpoint_serves_through_the_eval_entry(tmp_path,
                                                            capsys):
    from demf_tpu.zoo import synth_fcaf3d_batch
    from demf_tpu_torch.engine.weights import state_dict_from_jax
    cfg_path = os.path.join(ROOT, 'configs', 'synthetic', 'fcaf3d_tiny.py')
    cfg = Config.fromfile(cfg_path)
    jmodel = build_from_cfg(dict(cfg.model), JAX_DETECTORS)
    params, stats = random_variables(
        jmodel, synth_fcaf3d_batch(1, p=512, g=2), seed=2)
    ckpt = save_jax(str(tmp_path / 'jax'), params, stats, epoch=1)
    out = str(tmp_path / 'fcaf3d.pth')
    converter().main([cfg_path, ckpt, out])
    assert 'epoch 1, 10 classes' in capsys.readouterr().out
    payload = torch.load(out, weights_only=True)
    want = state_dict_from_jax(params, stats)
    assert set(payload['state_dict']) == set(want)
    for k, v in want.items():
        assert torch.equal(payload['state_dict'][k], v), k
    model = zoo.build_detector(cfg.model, 'cpu')
    assert load_checkpoint(out, model) == 1
    metrics = eval_entry.main([cfg_path, out, '--device', 'cpu', '--eval',
                               'mAP'])
    assert "'epoch': 1" in capsys.readouterr().out
    assert 'mAP_0.25' in metrics


@pytest.fixture(scope='module')
def mmcv_pair(tmp_path_factory):
    """The tiny DeMF's seeded weights as the port's own checkpoint and as
    an mmcv-format file of 3 completed epochs, both with CLASSES in an
    order of their own."""
    root = tmp_path_factory.mktemp('mmcv')
    cfg = Config.fromfile(DEMF_CFG)
    model = zoo.build_detector(cfg.model, 'cpu', seed=4)
    head = model.pts_bbox_head
    with torch.no_grad():      # boxes that hold points, so NMS has work
        for i in range(len(head.decoder) + 1):
            getattr(head, f'conv_pred{i}').conv_reg.bias[3:6] += 1.5
    optimizer = build_optimizer(model, cfg.optimizer,
                                model.frozen_param_patterns())
    classes = CLASSES[::-1]
    own = save_checkpoint(str(root / 'own'), model, optimizer, epoch=2,
                          meta=dict(CLASSES=list(classes)))
    mmcv = str(root / 'released.pth')
    torch.save(dict(
        state_dict=OrderedDict(model.state_dict()),
        meta=dict(epoch=3, iter=36, CLASSES=classes,
                  mmcv_version='1.4.0', config=cfg.dump()),
        optimizer=dict(state={}, param_groups=[
            dict(lr=0.004, params=[i]) for i in range(3)])), mmcv)
    return cfg, own, mmcv, classes


def test_mmcv_file_runs_through_the_eval_entry(mmcv_pair, tmp_path,
                                               capsys):
    _, own, mmcv, classes = mmcv_pair
    results = []
    for i, path in enumerate((mmcv, own)):
        out = str(tmp_path / f'{i}.pkl')
        np.random.seed(1)
        eval_entry.main([DEMF_CFG, path, '--device', 'cpu', '--out', out])
        printed = capsys.readouterr().out
        assert f'using CLASSES from checkpoint meta: {classes}' in printed \
            or f'using CLASSES from checkpoint meta: {list(classes)}' in \
            printed
        assert "'epoch': 2" in printed
        with open(out, 'rb') as f:
            results.append(pickle.load(f))
    assert len(results[0]) == 4
    assert sum(len(r['scores_3d']) for r in results[0]) > 0
    for got, want in zip(*results):
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


def test_mmcv_file_epoch_warm_start_and_no_resume(mmcv_pair):
    cfg, _, mmcv, classes = mmcv_pair
    model = zoo.build_detector(cfg.model, 'cpu', seed=9)
    assert load_checkpoint(mmcv, model) == 2          # 3 completed epochs
    meta = load_meta(mmcv)
    assert meta['epoch'] == 2 and tuple(meta['CLASSES']) == classes
    assert meta['mmcv_version'] == '1.4.0' and meta['iter'] == 36
    fresh = zoo.build_detector(cfg.model, 'cpu', seed=9)
    assert load_weights(mmcv, fresh) == ([], [])
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    optimizer = build_optimizer(fresh, cfg.optimizer,
                                fresh.frozen_param_patterns())
    with pytest.raises(ValueError, match='mmcv-format'):
        load_checkpoint(mmcv, fresh, optimizer)


def test_a_file_that_needs_other_globals_is_refused_by_name(mmcv_pair,
                                                           tmp_path):
    cfg = mmcv_pair[0]
    model = zoo.build_detector(cfg.model, 'cpu')
    path = str(tmp_path / 'pickled.pth')
    torch.save(dict(state_dict=model.state_dict(),
                    meta=dict(epoch=1, args=argparse.Namespace(lr=1))), path)
    with pytest.raises(ValueError, match=r'argparse\.Namespace'):
        load_checkpoint(path, model)
    with pytest.raises(ValueError, match=r'argparse\.Namespace'):
        load_meta(path)
