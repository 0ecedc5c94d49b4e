"""The port's VoteNet against the JAX package's, on the CPU.

The tiny VoteNet of ``configs/synthetic/votenet_tiny.py`` (the baseline's
``CAVoteHead`` with ``ClassAgnosticBBoxCoder``, read by both packages as it
is) with exact ball query and distance thresholds wide enough that its 16
proposals include positives, from the same weights (carried by
``state_dict_from_jax``) and batch (``zoo.synth_points_batch``, GT boxes
three times their size so that points and proposals fall in them):

* the train-mode forward: every field of the results within 1e-3 of that
  tensor's largest (BatchNorm on the batch statistics of 32 proposals
  carries float32 rounding on into the scores: 1.4e-4 seen), seeds and
  sampling indices equal;
* each loss term within 1e-4 relative, and the same for a batch whose
  scenes have no GT (the fake box);
* one train step (``zoo.build_trainer``): losses within 1e-4, the
  gradient norm within 1e-3 and each gradient within 1e-3 of that
  tensor's largest (after the same clip), the BatchNorm running
  statistics within 1e-5;
* the eval forward and ``get_bboxes``: boxes and scores within 1e-4 of
  their largest, labels and valid masks equal.

``tests/test_torch_vote_head.py`` runs the same checks on the standard
``VoteHead``.  Both entry points run the tiny config end to end to an mAP,
in float32 and under the bf16 policy.
"""
import copy
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import eval as eval_entry
from demf_tpu_torch import train, zoo
from demf_tpu_torch.engine import batch_to_device, state_dict_from_jax
from demf_tpu_torch.utils.precision import resolve_compute_dtype

TINY = zoo.load_model_cfg('synthetic/votenet_tiny.py')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def exact_cfg(model_cfg):
    """The model with exact ball query (the port's rule) and distance
    thresholds under which the tiny model's proposals hold positives."""
    cfg = copy.deepcopy(dict(model_cfg))
    cfg['backbone']['sa_cfg']['ball_query_exact'] = True
    cfg['bbox_head']['vote_aggregation_cfg']['ball_query_exact'] = True
    cfg['train_cfg'] = dict(cfg['train_cfg'], pos_distance_thr=1.5,
                            neg_distance_thr=2.5)
    return cfg


def vote_batch(points=1024):
    batch = zoo.synth_points_batch(2, points, g=12, seed=1)
    batch['gt_bboxes_3d'][..., 3:6] *= 3
    return batch


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _perturbed(jmodel, jbatch):
    """Initialized, then perturbed params and random running statistics."""
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(0)
    params = {k: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) *
              0.02 for k, v in flatten_params(variables['params']).items()}
    stats = {k: (rng.randn(*v.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
             for k, v in flatten_params(variables['batch_stats']).items()}
    return params, stats


def run_pair(model_cfg, optimizer_cfg, points=1024):
    """The JAX package and the port on the same weights and batch: train
    forward, losses (also without GT), gradients, new statistics, and the
    eval forward with ``get_bboxes``."""
    jmodel = build_from_cfg(model_cfg, JAX_DETECTORS)
    batch = vote_batch(points)
    empty = dict(batch, gt_valid=np.zeros_like(batch['gt_valid']))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = _perturbed(jmodel, jbatch)
    jstats = unflatten_params(stats)

    def loss_fn(p, b):
        results, mutated = jmodel.apply(
            {'params': p, 'batch_stats': jstats}, b, train=True,
            mutable=['batch_stats'])
        losses = jmodel.loss(results, b)
        return sum(losses.values()), (results, losses,
                                      mutated['batch_stats'])

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (total, (results, losses, new_bs)), grads = jax.device_get(
        step(unflatten_params(params), jbatch))
    (_, (_, empty_losses, _)), _ = jax.device_get(step(
        unflatten_params(params),
        jax.tree_util.tree_map(jnp.asarray, empty)))

    @jax.jit
    def infer(p, b):
        res = jmodel.apply({'params': p, 'batch_stats': jstats}, b,
                           train=False)
        return res, jmodel.get_bboxes(res, b)

    eval_results, det = jax.device_get(infer(unflatten_params(params),
                                             jbatch))
    jax_out = dict(results=results, losses=losses, total=total,
                   empty_losses=empty_losses, grads=flatten_params(grads),
                   grad_norm=float(optax.global_norm(grads)),
                   batch_stats=flatten_params(new_bs),
                   eval_results=eval_results, det=det)

    sd = state_dict_from_jax(params, stats)
    tbatch = batch_to_device(batch, 'cpu')

    def loaded():
        m = zoo.build_detector(model_cfg, 'cpu')
        m.load_state_dict(sd, strict=True)
        return m

    model = loaded().train()
    with torch.no_grad():
        results_t = model(tbatch)
        port = dict(results=results_t, losses=model.loss(results_t, tbatch),
                    empty_losses=model.loss(results_t, batch_to_device(
                        empty, 'cpu')))
    model = loaded()
    with torch.inference_mode():
        port['eval_results'] = model(tbatch)
        port['det'] = model.get_bboxes(port['eval_results'], tbatch)
    model, _, train_step = zoo.build_trainer(
        dict(model=model_cfg, optimizer=optimizer_cfg['optimizer'],
             optimizer_config=optimizer_cfg['optimizer_config'],
             lr_config=optimizer_cfg['lr_config']), 'cpu')
    model.load_state_dict(sd, strict=True)
    port['metrics'] = train_step(tbatch, torch.Generator().manual_seed(0))
    port['model'] = model
    return jax_out, port


@pytest.fixture(scope='module')
def pair():
    return run_pair(exact_cfg(TINY.model), TINY)


RESULT_KEYS = ('seed_points', 'vote_points', 'vote_features',
               'vote_offset', 'aggregated_points', 'obj_scores',
               'sem_scores', 'dir_class', 'dir_res_norm', 'dir_res')


def check_results(got, want, keys, bound):
    for key in keys:
        assert _rel(got[key].detach(), want[key]) <= bound, key
    np.testing.assert_array_equal(np.asarray(got['seed_indices']),
                                  np.asarray(want['seed_indices']))


def check_losses(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        assert _rel(got[key], w) < 1e-4, key


def check_step(jax_out, port, max_norm):
    """Losses, gradient norm, each gradient (after the same clip) and the
    new running statistics of one train step."""
    metrics, model = port['metrics'], port['model']
    check_losses({k: v for k, v in metrics.items()
                  if k not in ('loss', 'grad_norm')}, jax_out['losses'])
    assert _rel(metrics['loss'], jax_out['total']) < 1e-4
    assert _rel(metrics['grad_norm'], jax_out['grad_norm']) < 1e-3
    scale = min(1.0, max_norm / jax_out['grad_norm'])
    want = state_dict_from_jax(jax_out['grads'], {})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    largest = max(np.abs(w.numpy()).max() for w in want.values()) * scale
    compared = 0
    for name, p in params.items():
        w = want[name].numpy() * scale
        got = p.grad.numpy()
        if np.abs(w).max() < 1e-6 * largest:     # a bias before a BN
            assert np.abs(got).max() < 1e-6 * largest, name
            continue
        err = np.abs(got - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (name, err)
        compared += 1
    assert compared > 30
    stats = model.state_dict()
    for key, w in state_dict_from_jax({}, jax_out['batch_stats']).items():
        if key.endswith(('running_mean', 'running_var')):
            assert _rel(stats[key], w) < 1e-5, key


def check_detections(got, want):
    assert set(got) == set(want)
    for key in ('boxes_3d', 'scores_3d'):
        assert _rel(got[key], want[key]) < 1e-4, key
    for key in ('labels_3d', 'valid'):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
    assert np.asarray(want['valid']).any()


def test_train_forward_matches_jax(pair):
    jax_out, port = pair
    check_results(port['results'], jax_out['results'],
                  RESULT_KEYS + ('distance', 'ref_points'), 1e-3)


def test_each_loss_term_matches_jax(pair):
    jax_out, port = pair
    for key, w in jax_out['losses'].items():
        assert float(w) > 0, key           # every term is exercised
    check_losses(port['losses'], jax_out['losses'])


def test_empty_gt_losses_match_jax(pair):
    jax_out, port = pair
    for v in port['empty_losses'].values():
        assert torch.isfinite(v)
    check_losses(port['empty_losses'], jax_out['empty_losses'])


def test_train_step_matches_jax(pair):
    jax_out, port = pair
    check_step(jax_out, port,
               TINY.optimizer_config['grad_clip']['max_norm'])


def test_eval_forward_and_get_bboxes_match_jax(pair):
    jax_out, port = pair
    check_results(port['eval_results'], jax_out['eval_results'],
                  RESULT_KEYS + ('distance',), 1e-4)
    check_detections(port['det'], jax_out['det'])
    assert port['det']['boxes_3d'].shape == (2, 160, 7)


def test_synth_points_batch_equals_jax():
    from demf_tpu import zoo as jzoo
    got = zoo.synth_points_batch(2, 300, g=5, seed=4)
    want = jzoo.synth_points_batch(2, 300, 5, seed=4)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(w))


def test_synth_batch_for_takes_the_detectors_type():
    """A VoteNet gets points only (16 scenes, 64 GT slots at full size),
    whatever attributes it has, and so does a subclass of it (the class
    names its batch); DeMF scenes and 2D images as before."""
    model = zoo.build_detector(zoo.tiny_votenet_model_cfg(), 'cpu')
    assert not hasattr(model, 'pts_backbone')
    batch = zoo.synth_batch_for(model, p=64)
    assert set(batch) == {'points', 'gt_bboxes_3d', 'gt_labels_3d',
                          'gt_valid'}
    assert batch['points'].shape == (16, 64, 4)
    assert batch['gt_bboxes_3d'].shape == (16, 64, 7)
    model.__class__ = type('TracedVoteNet', (type(model),), {})
    assert zoo.synth_batch_for(model, b=2, p=64)['points'].shape == (2, 64, 4)
    demf = zoo.build_detector(zoo.tiny_demf_model_cfg(), 'cpu')
    assert 'img' in zoo.synth_batch_for(demf, b=1, p=8, hw=(32, 32))
    with pytest.raises(NotImplementedError, match='no synthetic batch'):
        zoo.synth_batch_for(torch.nn.Linear(1, 1))


@pytest.mark.parametrize('options', [[], ['bf16=True']])
def test_entry_points_run_votenet_to_an_map(tmp_path, capsys, options):
    """Train (2 epochs, a checkpoint each, the eval hook at the end) and
    evaluate ``configs/synthetic/votenet_tiny.py``, points only, in float32
    and under the bf16 policy."""
    cfg = os.path.join(ROOT, 'configs', 'synthetic', 'votenet_tiny.py')
    wd = tmp_path / 'wd'
    argv = ['--device', 'cpu'] + (['--cfg-options'] + options
                                  if options else [])
    train.main([cfg, '--work-dir', str(wd)] + argv)
    out = capsys.readouterr().out
    assert '[eval @ epoch 2] ' in out and 'mAP_0.25' in out
    assert ('compute dtype: bfloat16' in out) == bool(options)
    assert 'image-feature cache' not in out
    metrics = eval_entry.main(
        [cfg, str(wd / 'checkpoints' / 'epoch_2.pth'), '--out',
         str(tmp_path / 'res.pkl')] + argv)
    assert {'mAP_0.25', 'mAP_0.50'} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert (tmp_path / 'res.pkl').exists()
    assert resolve_compute_dtype(dict(
        bf16=bool(options))) == (torch.bfloat16 if options else None)
