"""The port's FCAF3D (``demf_tpu_torch/models/{mink_resnet,fcaf3d}.py``)
against the JAX package's, on the CPU: the model of
``configs/synthetic/fcaf3d_tiny.py`` (MinkResNet18 at stem 16, a 32-wide
head) on the same weights (flax variables made with numpy at the shapes of
``jax.eval_shape``, no init compile, moved by ``state_dict_from_jax``) and
the same synthetic scenes (``synth_fcaf3d_batch``).

* every level's centerness, bbox_pred and cls_scores within 1e-4 of each
  tensor's largest value, the points and voxel sets equal, and
  ``get_bboxes``' kept boxes equal in number and within 1e-4;
* the weights' round trip: flax variables -> ``state_dict_from_jax`` ->
  the JAX package's ``port_fcaf3d_checkpoint`` gives the same variables,
  every torch key used once, the sparse kernels in MinkowskiEngine's tap
  order;
* the eval entry serves the tiny config from a ``.pth`` of the port's
  weights to an mAP dict; the train entry trains the family (two
  ``--synthetic`` steps, a checkpoint the eval entry serves, and which the
  JAX package's ``port_fcaf3d_checkpoint`` ports back to JAX's eval forward
  within 1e-4 of the port's), the loss is a finite named dict, and one
  step under the bf16 policy through the train entry keeps float32 master
  weights (the step itself against JAX's bf16 step:
  ``tests/test_torch_fcaf3d_train.py``);
* the bf16 policy: the eval step under it gives float32 detections, and
  the port's own bf16 - float32 gap of every level output lies within a
  third and three times the JAX package's (seen: 0.55 to 1.6 times).
"""
import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.engine.torch_port import (flatten_params,
                                        port_fcaf3d_checkpoint,
                                        unflatten_params)
from demf_tpu.utils import precision as jprec
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import eval as eval_entry
from demf_tpu_torch import train as train_entry
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import batch_to_device, make_eval_step
from demf_tpu_torch.engine.weights import state_dict_from_jax

CFG = 'configs/synthetic/fcaf3d_tiny.py'
LEVEL_KEYS = ('centerness', 'bbox_pred', 'cls_scores')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The module on one intra-op thread: the tiny models' many small ops
    under the other test workers' threads slow by tens to hundreds of
    times with torch's default pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(jmodel, jbatch, seed=0):
    """Flat params and statistics at ``init``'s shapes (by
    ``jax.eval_shape``): He-scaled kernels, small biases, BatchNorm scales
    near 1 and statistics spread."""
    shapes = jax.eval_shape(lambda r, b: jmodel.init(r, b, train=False),
                            jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(seed)
    params = {}
    for k, s in flatten_params(shapes['params']).items():
        if k.endswith('scale'):
            v = 1.0 + rng.randn(*s.shape) * 0.02
        elif k.endswith('bias') or k.endswith('level_embeds'):
            v = rng.randn(*s.shape) * 0.02
        else:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        params[k] = v.astype(np.float32)
    stats = {k: (rng.randn(*s.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, s.shape)).astype(np.float32)
             for k, s in flatten_params(shapes['batch_stats']).items()}
    return params, stats


def level_errors(got, want):
    """Max error over each level output's largest, by (level, key)."""
    out = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for key in LEVEL_KEYS:
            w_ = np.asarray(w[key], np.float32)
            out[i, key] = float(np.abs(g[key].float().numpy() - w_).max() /
                                np.abs(w_).max())
    return out


def kept(det, k):
    v = np.asarray(det['valid'][k])
    return (np.asarray(det['boxes_3d'][k])[v],
            np.asarray(det['scores_3d'][k])[v],
            np.asarray(det['labels_3d'][k])[v])


def detections_agree(got, want, tol=1e-4):
    """The kept detections of every scene: the same number and labels, the
    boxes and scores within ``tol`` of the largest."""
    n = 0
    for k in range(np.asarray(want['valid']).shape[0]):
        gb, gs, gl = kept({key: v.numpy() for key, v in got.items()}, k)
        wb, ws, wl = kept(want, k)
        assert len(gb) == len(wb) and np.array_equal(gl, wl)
        if len(wb):
            assert np.abs(gb - wb).max() <= tol * np.abs(wb).max()
            assert np.abs(gs - ws).max() <= tol
        n += len(wb)
    return n


@pytest.fixture(scope='module')
def fcaf3d():
    """JAX and the port on the same weights and scenes: (JAX results and
    detections, the port's model, the torch batch, params, stats, JAX's
    results under its bf16 policy, the jitted JAX step of (params, stats,
    batch) -> those three, the JAX batch)."""
    cfg = dict(zoo.load_model_cfg('synthetic/fcaf3d_tiny.py').model)
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = zoo.synth_fcaf3d_batch(2, p=2048, g=4, seed=0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = jax_variables(jmodel, jbatch)

    @jax.jit
    def serve(p, s, b):
        res = jmodel.apply({'params': p, 'batch_stats': s}, b, train=False)
        with jprec.compute_dtype_scope('bfloat16'):
            bf16 = jmodel.apply({'params': jprec.cast_floating(
                p, jnp.bfloat16), 'batch_stats': s}, b, train=False)
        return res, jmodel.get_bboxes(res, b), jprec.cast_floating(
            bf16, 'float32')

    want, want_det, want_bf16 = jax.device_get(serve(
        unflatten_params(params), unflatten_params(stats), jbatch))
    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return want, want_det, model, batch_to_device(batch, 'cpu'), params, \
        stats, want_bf16, serve, jbatch


@pytest.fixture(scope='module')
def port_run(fcaf3d):
    model, tbatch = fcaf3d[2:4]
    with torch.inference_mode():
        results = model(tbatch)
        return results, model.get_bboxes(results, tbatch)


@pytest.mark.parametrize('key', LEVEL_KEYS)
def test_levels_equal_jax(fcaf3d, port_run, key):
    want = fcaf3d[0]['head_outs']
    got = port_run[0]['head_outs']
    assert len(got) == len(want) == 4
    for (_, k), err in level_errors(got, want).items():
        if k == key:
            assert err <= 1e-4, (k, err)


def test_voxel_levels_equal_jax(fcaf3d, port_run):
    for g, w in zip(port_run[0]['head_outs'], fcaf3d[0]['head_outs']):
        assert np.array_equal(g['valid'].numpy(), np.asarray(w['valid']))
        assert np.abs(g['points'].numpy() - np.asarray(w['points'])).max() \
            <= 1e-6
        assert g['valid'].any()


def test_get_bboxes_equals_jax(fcaf3d, port_run):
    det = port_run[1]
    assert tuple(det['boxes_3d'].shape) == tuple(
        np.asarray(fcaf3d[1]['boxes_3d']).shape) == (2, 10 * 64, 7)
    assert detections_agree(det, fcaf3d[1]) > 0


def test_weights_round_trip_through_port_fcaf3d_checkpoint(fcaf3d):
    """``state_dict_from_jax`` is the inverse of the JAX package's
    ``port_fcaf3d_checkpoint``: the same variables back, every key used
    once (BatchNorm's step counters aside); mmdet3d's layouts (a 1x1x1
    kernel (C_in, C_out), the class bias (1, C)); taps in
    MinkowskiEngine's order (the first axis fastest)."""
    model, _, params, stats = fcaf3d[2:6]
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params,
                                                       stats).items()}
    assert sd['backbone.layer1.0.downsample.0.kernel'].ndim == 2
    assert sd['head.cls_conv.bias'].shape == (1, 10)
    stem = params['backbone/stem_conv']
    assert np.array_equal(sd['backbone.conv1.kernel'][1], stem[9])
    template = {'params': unflatten_params(params),
                'batch_stats': unflatten_params(stats)}
    back, report = port_fcaf3d_checkpoint(sd, template, depth=18,
                                          strict=True)
    # mmcv's BatchNorm step counters are the only keys flax has no use for
    assert not report['unmatched_flax_keys']
    assert all(k.endswith('num_batches_tracked')
               for k in report['unused_torch_keys'])
    got = flatten_params(back['params'])
    assert set(got) == set(params)
    for k, v in params.items():
        assert np.array_equal(got[k], v), k
    got = flatten_params(back['batch_stats'])
    for k, v in stats.items():
        assert np.array_equal(got[k], v), k
    assert set(sd) == set(model.state_dict())


def test_eval_entry_serves_the_tiny_config(fcaf3d, tmp_path, capsys):
    model = fcaf3d[2]
    path = str(tmp_path / 'fcaf3d.pth')
    torch.save(dict(state_dict=model.state_dict(), epoch=0), path)
    metrics = eval_entry.main([CFG, path, '--device', 'cpu', '--eval', 'mAP'])
    assert 'mAP_0.25' in metrics and 'mAP_0.50' in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    assert 'mAP_0.25' in capsys.readouterr().out


FAMILY = [CFG, 'configs/synthetic/demf_fcaf3d_tiny.py']


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """config -> the checkpoint of two ``--synthetic`` steps of the train
    entry on the CPU (2 scenes of 1,024 points, 64x96 images), made once."""
    made = {}

    def checkpoint(cfg):
        if cfg not in made:
            wd = tmp_path_factory.mktemp('train')
            train_entry.main([cfg, '--device', 'cpu', '--synthetic',
                              '--steps', '2', '--batch', '2', '--points',
                              '1024', '--hw', '64', '96', '--work-dir',
                              str(wd)])
            made[cfg] = wd / 'checkpoints' / 'epoch_1.pth'
        return made[cfg]
    return checkpoint


@pytest.mark.parametrize('cfg', FAMILY)
def test_train_entry_trains_the_family(cfg, trained):
    """Two ``--synthetic`` steps write a checkpoint of finite weights,
    which the eval entry serves to an mAP dict."""
    path = trained(cfg)
    weights = [v for v in torch.load(path, weights_only=False)[
        'state_dict'].values() if v.is_floating_point()]
    assert weights and all(torch.isfinite(v).all() for v in weights)
    metrics = eval_entry.main([cfg, str(path), '--device', 'cpu', '--eval',
                               'mAP'])
    assert 'mAP_0.25' in metrics
    assert all(np.isfinite(v) for v in metrics.values())


def test_trained_checkpoint_ports_back_to_jax(fcaf3d, trained):
    """The train entry's checkpoint, ported back by the JAX package's
    ``port_fcaf3d_checkpoint`` (strict: every leaf, no key left): JAX's
    eval forward on it within 1e-4 of the port's on the same checkpoint."""
    params, stats, serve, jbatch = fcaf3d[4], fcaf3d[5], fcaf3d[7], fcaf3d[8]
    sd = torch.load(trained(CFG), weights_only=False)['state_dict']
    template = {'params': unflatten_params(params),
                'batch_stats': unflatten_params(stats)}
    back, report = port_fcaf3d_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, template, depth=18,
        strict=True)
    assert not report['unmatched_flax_keys']
    want = jax.device_get(serve(back['params'], back['batch_stats'],
                                jbatch))[0]
    model = copy.deepcopy(fcaf3d[2])
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = model(fcaf3d[3])
    errs = level_errors(got['head_outs'], want['head_outs'])
    assert max(errs.values()) <= 1e-4, errs
    # the two steps moved the weights away from the fixture's
    assert not torch.equal(sd['head.cls_conv.bias'],
                           fcaf3d[2].state_dict()['head.cls_conv.bias'])


def test_loss_is_a_finite_named_dict(fcaf3d):
    # a copy: train mode moves the BatchNorm statistics of the shared model
    model = copy.deepcopy(fcaf3d[2]).train()
    tbatch = fcaf3d[3]
    losses = model.loss(model(tbatch), tbatch)
    assert set(losses) == {'loss_cls', 'loss_centerness', 'loss_bbox'}
    assert all(v.dim() == 0 and torch.isfinite(v) for v in losses.values())
    assert losses['loss_cls'] > 0


@pytest.mark.parametrize('cfg', FAMILY)
def test_bf16_train_entry_trains_the_family(cfg, tmp_path, capsys):
    """One ``--synthetic`` step under the bf16 policy (``bf16=True``: bf16
    copies of the weights, K14 and K16 on their bf16 entries on the card,
    their plain versions here): every logged loss finite and the
    classification loss positive; the checkpoint's weights, BatchNorm
    statistics and AdamW state float32 and finite (the master
    weights)."""
    train_entry.main([cfg, '--device', 'cpu', '--synthetic', '--steps', '1',
                      '--batch', '2', '--points', '1024', '--hw', '64', '96',
                      '--work-dir', str(tmp_path), '--cfg-options',
                      'bf16=True'])
    line = re.search(r'Epoch \[1/1\]\[1\] (.*) \(',
                     capsys.readouterr().out).group(1)
    logged = {k: float(v) for k, v in re.findall(r'(\S+): (\S+)', line)}
    assert logged['loss_cls'] > 0
    assert all(np.isfinite(v) for v in logged.values()), logged
    ckpt = torch.load(tmp_path / 'checkpoints' / 'epoch_1.pth',
                      weights_only=False)
    floats = [v for v in ckpt['state_dict'].values()
              if v.is_floating_point()]
    floats += [v for st in ckpt['optimizer']['state'].values()
               for v in st.values() if torch.is_tensor(v) and v.numel() > 1]
    assert floats and all(v.dtype == torch.float32 and
                          torch.isfinite(v).all() for v in floats)


def test_eval_step_under_the_bf16_policy(fcaf3d, port_run):
    """Under the policy the voxel features and the weights are bf16 (K14's
    bf16 entry on the card), the coordinates float32: the detections come
    back float32 and finite, and the port rounds about as much as the JAX
    package does: its bf16 - float32 gap, tensor by tensor, within a third
    and three times JAX's (each measured from its own float32 run; the two
    float32 runs agree to 1e-4 above)."""
    model, tbatch = fcaf3d[2:4]
    step = make_eval_step(model, torch.bfloat16)
    det = step(tbatch)
    assert det['boxes_3d'].dtype == torch.float32
    assert torch.isfinite(det['boxes_3d']).all()
    from demf_tpu_torch.utils import precision as prec
    with torch.inference_mode():
        bf16 = prec.cast_floating(prec.policy_call(model, torch.bfloat16,
                                                   tbatch), torch.float32)
    port_gap = level_errors(bf16['head_outs'], [
        {k: v.numpy() for k, v in lvl.items()}
        for lvl in port_run[0]['head_outs']])
    jax_gap = level_errors([
        {k: torch.from_numpy(np.asarray(v)) for k, v in lvl.items()}
        for lvl in fcaf3d[6]['head_outs']], fcaf3d[0]['head_outs'])
    ratio = np.array([port_gap[k] / jax_gap[k] for k in jax_gap])
    assert min(jax_gap.values()) > 0
    assert np.all((ratio >= 1 / 3) & (ratio <= 3)), ratio
