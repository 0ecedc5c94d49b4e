"""The port's ImVoteNet against the JAX package's, on the CPU.

The tiny ImVoteNet of ``zoo.tiny_imvotenet_model_cfg`` (equal to the JAX
tests' ``tiny_imvotenet_cfg``: ResNet-50 at full width and the baseline's
RPN / RoI wiring at 16 channels, small towers, 32 seeds) on a 64x96 scene
of 128 points, from the same weights (initialized on the JAX side,
perturbed, carried by ``state_dict_from_jax``) and the same uniform draws
(the JAX side's ``jax.random.uniform`` inside its ImVoteNet and VoteFusion
modules returns the test's draws; the port takes them as ``draws``).
``test_cfg.img_rcnn.score_thr`` is 0.05 on both sides: random weights score
the R-CNN's 11 classes near 1 / 11, under the baseline's 0.1; the GT boxes
are three times their size and the distance thresholds wide (1.5 / 2.5 m),
so that every loss term has positives.

* the eval forward: the 2D boxes and their mask (equal), each tower's
  predictions within 1e-4 of that tensor's largest, ``get_bboxes``' boxes
  and scores within 1e-4 of their largest, labels and valid masks equal;
* one stage-2 train step: the 2D boxes after the half-drop equal, each loss
  term within 1e-4 relative, each gradient within 1e-3 of that tensor's
  largest (after the same clip), the running statistics within 1e-5, and
  the frozen 2D branch untouched;
* ``ImVoteNet_Deformdetr``'s fusion mode (the JAX tests' tiny fusion
  model, its DETR classifier's bias raised on both sides so that 2D boxes
  pass its 0.09): the train-mode forward and each loss term;
* ``VoteFusion`` with flip, rotation and scale in the meta: features
  within 1e-5 of their largest, masks equal; ``sample_valid_seeds`` on the
  same draws: indices equal;
* both entry points on ``demf_tpu_torch/configs/imvotenet_tiny.py``, in
  float32 and under the bf16 policy (``bf16=True`` or ``fp16=dict(...)``),
  the train entry on ``imvotenet_frcnn_tiny.py`` and both entries on
  ``imvotenet_deform_tiny.py`` (``ImVoteNet_Deformdetr``'s fusion) under
  the policy;
* under the bf16 policy, from the same weights, batch and draws: the FPN
  levels and RPN maps against JAX's (the port's bf16 - float32 gap within
  a factor of 3 of JAX's, its bf16 maps within twice JAX's gap of JAX's);
  on JAX's bf16 2D boxes (bf16 ties in the RPN's scores let each run keep
  other proposals), the eval forward's towers within 2e-2 and one train
  step's losses within 3e-2 relative and gradients (before the clip)
  within twice JAX's own bf16 - float32 gap.

Every comparison asserts that some 2D boxes are valid and some seeds
carry image votes.
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
from demf_tpu.models import imvotenet as jimvotenet
from demf_tpu.models import vote_fusion as jfusion
from demf_tpu.utils import precision as jprec
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import eval as eval_entry
from demf_tpu_torch import train, zoo
from demf_tpu_torch.engine import batch_to_device, state_dict_from_jax
from demf_tpu_torch.models import imvotenet, vote_fusion
from demf_tpu_torch.utils import precision as prec
from test_demf import demf_batch
from test_detr_imvotenet import tiny_imvotenet_deform_cfg
from test_rpn_roi import tiny_imvotenet_cfg
from test_torch_data import assert_same, both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(ROOT, 'demf_tpu_torch', 'configs',
                        'imvotenet_tiny.py')
OPTIM = dict(optimizer=dict(type='AdamW', lr=0.008, weight_decay=0.01),
             optimizer_config=dict(grad_clip=dict(max_norm=10, norm_type=2)),
             lr_config=dict(policy='step', warmup=None, step=[24, 32]))
RESULT_KEYS = ('seed_points', 'vote_points', 'vote_features', 'vote_offset',
               'aggregated_points', 'obj_scores', 'sem_scores', 'dir_class',
               'dir_res_norm', 'distance')


def _plain(cfg):
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [_plain(v) for v in cfg]
    return cfg


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def tiny_cfg():
    """The tiny model, 2D boxes over 0.05 and distance thresholds under
    which its 8 proposals a tower hold positives (as the VoteNet tests)."""
    cfg = copy.deepcopy(zoo.tiny_imvotenet_model_cfg())
    cfg['test_cfg']['img_rcnn']['score_thr'] = 0.05
    cfg['train_cfg']['pts'] = dict(cfg['train_cfg']['pts'],
                                   pos_distance_thr=1.5,
                                   neg_distance_thr=2.5)
    return cfg


def scene_batch(seed):
    """The JAX tests' ImVoteNet scene (2 x 128 points, 64x96 images), its GT
    boxes three times their size so that points and proposals fall in
    them."""
    batch = jax.tree_util.tree_map(np.array, demf_batch(
        np.random.RandomState(seed)))
    batch['gt_bboxes_3d'][..., 3:6] *= 3
    return batch


class _Random:
    """``jax.random`` whose ``uniform`` returns the draw of its shape."""

    def __init__(self, draws):
        self.draws = draws

    def uniform(self, key, shape, *args, **kwargs):
        return jnp.asarray(self.draws[tuple(shape)])

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _Jax:
    """``jax`` as the JAX package's ImVoteNet modules see it in a test."""

    def __init__(self, draws):
        self.random = _Random(draws)

    def __getattr__(self, name):
        return getattr(jax, name)


def fixed_draws(mp, draws):
    """The JAX package's ImVoteNet and VoteFusion draw ``draws`` (shape ->
    array) in place of ``jax.random.uniform``."""
    proxy = _Jax(draws)
    mp.setattr(jimvotenet, 'jax', proxy)
    mp.setattr(jfusion, 'jax', proxy)


def perturbed(variables, rng):
    params = {k: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) *
              0.02 for k, v in flatten_params(variables['params']).items()}
    stats = {k: (rng.randn(*v.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
             for k, v in flatten_params(variables['batch_stats']).items()}
    return params, stats


class _Recorder:
    """The port's ``sample_valid_seeds``, keeping the masks it was given."""

    def __init__(self):
        self.masks = []

    def __call__(self, mask, *args, **kwargs):
        self.masks.append(mask.detach().clone())
        return vote_fusion.sample_valid_seeds(mask, *args, **kwargs)


@pytest.fixture(scope='module')
def pair():
    """The JAX package and the port on the same weights, batch and draws:
    the eval forward with ``get_bboxes`` and one train step."""
    cfg = tiny_cfg()
    jmodel = build_from_cfg(copy.deepcopy(cfg), JAX_DETECTORS)
    batch = scene_batch(2)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    rng = np.random.RandomState(0)
    draws = {(2, 8): rng.rand(2, 8).astype(np.float32),       # half-drop
             (2, 96): rng.rand(2, 96).astype(np.float32)}     # seeds
    out = dict(batch=batch, draws=draws)
    with pytest.MonkeyPatch.context() as mp:
        fixed_draws(mp, draws)
        variables = jax.jit(lambda r, b: jmodel.init(
            {'params': r, 'sample': r}, b, train=False))(
                jax.random.PRNGKey(0), jbatch)
        params, stats = perturbed(variables, rng)
        jstats = unflatten_params(stats)

        def loss_fn(p, b):
            results, mutated = jmodel.apply(
                {'params': p, 'batch_stats': jstats}, b, train=True,
                mutable=['batch_stats'], rngs={'sample': jax.random.PRNGKey(1)})
            losses = jmodel.loss(results, b)
            return sum(losses.values()), (results, losses,
                                          mutated['batch_stats'])

        (total, (results, losses, new_bs)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                unflatten_params(params), jbatch))

        @jax.jit
        def infer(p, b):
            res = jmodel.apply({'params': p, 'batch_stats': jstats}, b,
                               train=False)
            return res, jmodel.get_bboxes(res, b)

        eval_results, det = jax.device_get(infer(unflatten_params(params),
                                                 jbatch))
    out['jax'] = dict(results=results, losses=losses, total=total,
                      grads=flatten_params(grads),
                      grad_norm=float(optax.global_norm(grads)),
                      batch_stats=flatten_params(new_bs),
                      eval_results=eval_results, det=det)
    out.update(cfg=cfg, jmodel=jmodel, params=params, stats=stats)

    sd = state_dict_from_jax(params, stats)
    tbatch = batch_to_device(batch, 'cpu')
    recorder = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(imvotenet, 'sample_valid_seeds', recorder)
        model = zoo.build_detector(cfg, 'cpu')
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            eval_results = model(tbatch, draws=dict(
                seeds=torch.from_numpy(draws[(2, 96)])))
            out['port'] = dict(eval_results=eval_results,
                               det=model.get_bboxes(eval_results, tbatch))
        model, _, step = zoo.build_trainer(dict(model=cfg, **OPTIM), 'cpu')
        model.load_state_dict(sd, strict=True)
        frozen = {k: v.clone() for k, v in model.state_dict().items()
                  if k.startswith(model.img_branch)}
        forward = model.forward
        model.forward = lambda *a, **k: forward(*a, draws={
            key: torch.from_numpy(draws[shape]) for key, shape in
            (('bboxes_2d', (2, 8)), ('seeds', (2, 96)))}, **k)
        results = {}
        loss = model.loss
        model.loss = lambda r, b: (results.update(r), loss(r, b))[1]
        out['port'].update(metrics=step(tbatch, torch.Generator()),
                           results=results, model=model, frozen=frozen,
                           vote_masks=recorder.masks)
    return out


def test_tiny_model_cfg_equals_the_jax_config():
    assert _plain(zoo.tiny_imvotenet_model_cfg()) == _plain(
        tiny_imvotenet_cfg())


def test_full_config_loads_jax_parameters_strictly():
    """``configs/baseline/imvotenet.py`` at full width: the JAX package's
    parameters and statistics (their shapes, by ``jax.eval_shape``) carried
    by ``state_dict_from_jax`` are the port's state_dict, key for key and
    shape for shape."""
    cfg = zoo.load_model_cfg('baseline/imvotenet.py').model
    jmodel = build_from_cfg(copy.deepcopy(dict(cfg)), JAX_DETECTORS)
    batch = jax.tree_util.tree_map(jnp.asarray, demf_batch(
        np.random.RandomState(0), p=2048, hw=(128, 160)))
    shapes = jax.eval_shape(lambda r, b: jmodel.init(
        {'params': r, 'sample': r}, b, train=False), jax.random.PRNGKey(0),
        batch)
    params, stats = ({k: np.zeros(v.shape, np.float32) for k, v in
                      flatten_params(shapes[group]).items()}
                     for group in ('params', 'batch_stats'))
    sd = state_dict_from_jax(params, stats)
    model = zoo.build_detector(cfg, 'cpu')
    want = model.state_dict()
    assert set(sd) == set(want)
    for key, value in sd.items():     # a BN's count comes as 1-d
        if not key.endswith('num_batches_tracked'):
            assert tuple(value.shape) == tuple(want[key].shape), key
    model.load_state_dict(sd, strict=True)
    assert sum(v.numel() for v in want.values()
               if v.dtype == torch.float32) > 4e7


@pytest.mark.parametrize('which', ['train_pipeline', 'test_pipeline'])
def test_baseline_pipelines_equal_the_jax_packages(which):
    """``configs/baseline/imvotenet.py``'s own pipelines, unchanged (caffe
    ``Normalize``, ``Resize`` (1333, 600), ``Pad`` 32,
    ``MultiScaleFlipAug3D``, 20,000 points), on ``SyntheticSUNRGBD`` scenes
    of the real raw size: the port's samples equal the JAX package's."""
    pipeline = zoo.load_model_cfg('baseline/imvotenet.py')[which]
    jds, pds = both(dict(type='SyntheticSUNRGBD', num_scenes=2, seed=1,
                         pipeline=pipeline, test_mode=which != 'train_'
                         'pipeline'))
    np.random.seed(1)
    want = jds[1]
    np.random.seed(1)
    got = pds[1]
    boxes2d = (got.pop('gt_bboxes', None), want.pop('gt_bboxes', None))
    assert_same(got, want)
    if boxes2d[1] is not None:
        assert_same(boxes2d[0], boxes2d[1], 'gt_bboxes', atol=1e-3)
    assert np.asarray(got['img']).shape[-3:] == (608, 800, 3)


def test_synth_batch_is_the_imvotenet_scene():
    model = zoo.build_detector(tiny_cfg(), 'cpu')
    batch = zoo.synth_batch_for(model, b=1, p=64, seed=3)
    assert batch['img'].shape == (1, 608, 832, 3)
    np.testing.assert_array_equal(batch['img_meta']['img_shape'],
                                  [[600, 826]])
    assert batch['gt_bboxes_3d'].shape == (1, 64, 7)
    assert zoo.synth_batch_for(model, b=1, p=8, hw=(64, 96))[
        'img'].shape == (1, 64, 96, 3)


def check_boxes_2d(got, got_valid, want, want_valid):
    """Masks equal; the valid boxes [xyxy, score, class] within 1e-4 of the
    image's width (ResNet-50's float32 rounding, 1.4e-3 px seen)."""
    np.testing.assert_array_equal(np.asarray(got_valid),
                                  np.asarray(want_valid))
    v = np.asarray(want_valid)
    assert v.any()
    assert np.abs(np.asarray(got)[v] - np.asarray(want)[v]).max() < 1e-4 * 96


def check_towers(got, want, bound):
    for tower in ('joint', 'pts', 'img'):
        for key in RESULT_KEYS:
            assert _rel(got[tower][key].detach(), want[tower][key]) <= \
                bound, (tower, key)
        np.testing.assert_array_equal(np.asarray(got[tower]['seed_indices']),
                                      np.asarray(want[tower]['seed_indices']))


def test_eval_forward_and_get_bboxes_match_jax(pair):
    want, got = pair['jax'], pair['port']
    res, wres = got['eval_results'], want['eval_results']
    check_boxes_2d(res['bboxes_2d'], res['bboxes_2d_valid'],
                   wres['bboxes_2d'], wres['bboxes_2d_valid'])
    assert got['vote_masks'][0].any()            # seeds carry image votes
    check_towers(res, wres, 1e-4)
    det, wdet = got['det'], want['det']
    assert set(det) == set(wdet)
    assert tuple(det['boxes_3d'].shape) == (2, 80, 7)
    for key in ('boxes_3d', 'scores_3d'):
        assert _rel(det[key], wdet[key]) < 1e-4, key
    for key in ('labels_3d', 'valid'):
        np.testing.assert_array_equal(np.asarray(det[key]),
                                      np.asarray(wdet[key]))
    assert np.asarray(wdet['valid']).any()


def test_train_step_matches_jax(pair):
    want, got = pair['jax'], pair['port']
    res, wres = got['results'], want['results']
    # the half-drop keeps the same boxes, fewer than the eval forward
    check_boxes_2d(res['bboxes_2d'], res['bboxes_2d_valid'],
                   wres['bboxes_2d'], wres['bboxes_2d_valid'])
    assert int(res['bboxes_2d_valid'].sum()) < int(
        got['eval_results']['bboxes_2d_valid'].sum())
    assert got['vote_masks'][1].any()
    check_towers(res, wres, 1e-3)
    metrics, model = got['metrics'], got['model']
    assert set(want['losses']) == set(metrics) - {'loss', 'grad_norm'}
    for key, w in want['losses'].items():
        assert float(w) > 0, key
        assert _rel(metrics[key], w) < 1e-4, key
    assert _rel(metrics['loss'], want['total']) < 1e-4
    assert _rel(metrics['grad_norm'], want['grad_norm']) < 1e-3
    scale = min(1.0, 10.0 / want['grad_norm'])
    grads = state_dict_from_jax(
        {k: v for k, v in want['grads'].items()
         if not k.startswith(('img_backbone', 'img_neck', 'img_rpn_head',
                              'img_roi_head'))}, {})
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    assert set(grads) == set(params)
    largest = max(np.abs(w.numpy()).max() for w in grads.values()) * scale
    compared = 0
    for name, p in params.items():
        w = grads[name].numpy() * scale
        g = p.grad.numpy()
        if np.abs(w).max() < 1e-6 * largest:       # a bias before a BN
            assert np.abs(g).max() < 1e-6 * largest, name
            continue
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), name
        compared += 1
    assert compared > 60
    stats = model.state_dict()
    for key, w in state_dict_from_jax({}, want['batch_stats']).items():
        if key.endswith(('running_mean', 'running_var')):
            assert _rel(stats[key], w) < 1e-5, key
    # the frozen 2D branch: no gradient, no optimizer step, no new stats
    for key, before in got['frozen'].items():
        assert torch.equal(stats[key], before), key
    for name, p in model.named_parameters():
        if name.startswith(model.img_branch):
            assert not p.requires_grad and p.grad is None, name


@pytest.fixture(scope='module')
def deform_inputs():
    """``ImVoteNet_Deformdetr``'s fusion case: the JAX tests' tiny model
    without dropout, its weights (its DETR classifier's bias raised by 4 so
    that 2D boxes pass its 0.09), batch and draws -> (cfg, batch, params,
    stats, draws)."""
    cfg = tiny_imvotenet_deform_cfg()
    for layer in cfg['img_bbox_head']['transformer']['decoder'][
            'transformerlayers']['attn_cfgs']:
        layer['dropout'] = 0.0
    cfg['img_bbox_head']['transformer']['decoder']['transformerlayers'][
        'ffn_dropout'] = 0.0
    cfg['img_bbox_head']['transformer']['encoder']['transformerlayers'][
        'ffn_dropout'] = 0.0
    jmodel = build_from_cfg(copy.deepcopy(cfg), JAX_DETECTORS)
    batch = scene_batch(1)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    rng = np.random.RandomState(4)
    draws = {(2, 100): rng.rand(2, 100).astype(np.float32),
             (2, 96): rng.rand(2, 96).astype(np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        fixed_draws(mp, draws)
        variables = jax.jit(lambda r, b: jmodel.init(
            {'params': r, 'sample': r}, b, train=False))(
                jax.random.PRNGKey(0), jbatch)
    params, stats = perturbed(variables, rng)
    for key in params:
        if key.startswith('img_bbox_head') and 'fc_cls' in key and \
                key.endswith('bias'):
            params[key] = params[key] + 4.0
    return cfg, batch, params, stats, draws


@pytest.fixture(scope='module')
def deform_pair(deform_inputs):
    """``ImVoteNet_Deformdetr`` in its fusion mode (``deform_inputs``): the
    train-mode forward and losses on the same draws."""
    cfg, batch, params, stats, draws = deform_inputs
    jmodel = build_from_cfg(copy.deepcopy(cfg), JAX_DETECTORS)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        fixed_draws(mp, draws)

        @jax.jit
        def fwd_loss(p, b):
            results, _ = jmodel.apply(
                {'params': p, 'batch_stats': unflatten_params(stats)}, b,
                train=True, mutable=['batch_stats'],
                rngs={'sample': jax.random.PRNGKey(1),
                      'dropout': jax.random.PRNGKey(2)})
            return results, jmodel.loss(results, b)

        results, losses = jax.device_get(fwd_loss(unflatten_params(params),
                                                   jbatch))
    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model.train()
    tbatch = batch_to_device(batch, 'cpu')
    recorder = _Recorder()
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(imvotenet, 'sample_valid_seeds', recorder)
        got = model(tbatch, generator=torch.Generator(), draws=dict(
            bboxes_2d=torch.from_numpy(draws[(2, 100)]),
            seeds=torch.from_numpy(draws[(2, 96)])))
        got_losses = model.loss(got, tbatch)
    return dict(results=results, losses=losses, got=got,
                got_losses=got_losses, vote_masks=recorder.masks)


def test_deformdetr_fusion_mode_matches_jax(deform_pair):
    p = deform_pair
    got, want = p['got'], p['results']
    check_boxes_2d(got['bboxes_2d'], got['bboxes_2d_valid'],
                   want['bboxes_2d'], want['bboxes_2d_valid'])
    assert p['vote_masks'][0].any()
    check_towers(got, want, 1e-3)
    assert set(p['got_losses']) == set(p['losses'])
    for key, w in p['losses'].items():
        assert _rel(p['got_losses'][key], w) < 1e-4, key


@pytest.fixture(scope='module')
def deform_bf16_pair(deform_inputs):
    """``deform_inputs``' fusion in eval mode (BatchNorm on its running
    statistics) under the bf16 policy and in float32 in JAX (its MSDA
    with float32 gather planes, as the float32 pair runs it), and under
    the policy in the port on JAX's bf16 2D boxes (the DETR head's bf16
    scores rank the queries' boxes with ties); the losses of each."""
    cfg, batch, params, stats, draws = deform_inputs
    jmodel = build_from_cfg(copy.deepcopy(cfg), JAX_DETECTORS)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        fixed_draws(mp, draws)

        @jax.jit
        def fwd_loss(p, b):
            out = []
            for dtype in (jnp.bfloat16, None):
                q, c = p, b
                if dtype is not None:
                    q = jprec.cast_floating(p, dtype)
                    c = jprec.cast_batch(b, dtype)
                with jprec.compute_dtype_scope(dtype):
                    results = jmodel.apply(
                        {'params': q, 'batch_stats': unflatten_params(stats)},
                        c, train=False)
                results = jprec.cast_floating(results, 'float32')
                out.append((results, jmodel.loss(results, b)))
            return out

        (results, losses), (results32, losses32) = jax.device_get(
            fwd_loss(unflatten_params(params), jbatch))
    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    tbatch = batch_to_device(batch, 'cpu')
    boxes = (torch.tensor(results['bboxes_2d']),
             torch.tensor(results['bboxes_2d_valid']))
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(model, 'extract_bboxes_2d', lambda *a, **k: boxes)
        got = prec.cast_floating(prec.policy_call(
            model, torch.bfloat16, prec.cast_batch(tbatch, torch.bfloat16),
            draws=dict(seeds=torch.from_numpy(draws[(2, 96)]))),
            torch.float32)
        got_losses = model.loss(got, tbatch)
    return dict(results=results, losses=losses, results32=results32,
                losses32=losses32, got=got, got_losses=got_losses)


def test_deformdetr_fusion_mode_under_the_policy_matches_jax(
        deform_bf16_pair):
    """The fusion mode of ``ImVoteNet_Deformdetr`` under the bf16 policy,
    on JAX's bf16 2D boxes: each tower within 2e-2 of the tensor's largest
    of JAX's bf16 forward, and each loss term within 3e-2 relative (or
    twice JAX's own bf16 - float32 gap where that is larger)."""
    p = deform_bf16_pair
    assert p['got']['bboxes_2d_valid'].any()
    check_towers(p['got'], p['results'], 2e-2)
    assert set(p['got_losses']) == set(p['losses'])
    for key, w in p['losses'].items():
        gap = _rel(w, p['losses32'][key])
        assert _rel(p['got_losses'][key], w) <= max(3e-2, 2 * gap), key


def fusion_case(seed=0):
    """Seeds, score-sorted 2D boxes and a meta with flip, rotation, scale
    and translation set, on a 64x96 image."""
    rng = np.random.RandomState(seed)
    batch = jax.device_get(demf_batch(rng, p=200))
    meta = dict(batch['img_meta'])
    angle = rng.uniform(-0.5, 0.5, 2)
    rot = np.zeros((2, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(angle)
    rot[:, 0, 1] = np.sin(angle)
    rot[:, 1, 0] = -np.sin(angle)
    rot[:, 2, 2] = 1
    meta.update(pcd_rotation=rot,
                pcd_scale_factor=np.array([1.1, 0.9], np.float32),
                pcd_trans=rng.randn(2, 3).astype(np.float32) * 0.1,
                pcd_horizontal_flip=np.array([True, False]),
                flip=np.array([False, True]),
                scale_factor=np.array([[1.0, 1.0], [0.8, 0.8]], np.float32))
    xy = rng.uniform(0, 80, (2, 12, 2))
    wh = rng.uniform(10, 60, (2, 12, 2))
    boxes = np.concatenate([xy, xy + wh, np.sort(rng.rand(2, 12, 1), 1)[
        :, ::-1], rng.randint(0, 12, (2, 12, 1))], -1).astype(np.float32)
    valid = rng.rand(2, 12) < 0.8
    seeds = batch['points'][..., :3]
    return batch['img'], boxes, valid, seeds, meta


def test_vote_fusion_matches_jax():
    img, boxes, valid, seeds, meta = fusion_case()
    want_f, want_m = jax.device_get(jfusion.VoteFusion(10, 3)(
        jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(seeds), {k: jnp.asarray(v) for k, v in meta.items()}))
    t = torch.from_numpy
    got_f, got_m = vote_fusion.VoteFusion(10, 3)(
        t(img), t(boxes), t(valid), t(seeds), {k: t(np.asarray(v))
                                               for k, v in meta.items()})
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert want_m.reshape(2, 3, -1).any(-1).all()       # every slot used
    assert _rel(got_f, want_f) < 1e-5


def test_sample_valid_seeds_matches_jax_on_the_same_draws():
    rng = np.random.RandomState(5)
    mask = rng.rand(3, 96) < np.array([[0.05], [0.5], [0.9]])
    u = rng.rand(3, 96).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        fixed_draws(mp, {(3, 96): u})
        want = np.asarray(jfusion.sample_valid_seeds(
            jnp.asarray(mask), 32, jax.random.PRNGKey(0)))
    got = vote_fusion.sample_valid_seeds(torch.from_numpy(mask), 32,
                                         u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = vote_fusion.sample_valid_seeds(
        torch.from_numpy(mask), 32, torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 32) and len(set(drawn[2].tolist())) == 32


def test_half_drop_keeps_the_ceiling_of_half():
    valid = torch.tensor([[True] * 5 + [False] * 3, [False] * 8,
                          [True] * 8])
    kept = imvotenet.half_drop(valid, torch.Generator().manual_seed(0))
    assert kept.sum(-1).tolist() == [3, 0, 4]
    assert not (kept & ~valid).any()


def test_entry_points_run_imvotenet_to_an_map(tmp_path, capsys):
    """Train the tiny config (an epoch of 2 steps, a checkpoint, the eval
    hook) and evaluate its checkpoint to the mAP, in float32 and under the
    bf16 policy."""
    wd = tmp_path / 'wd'
    train.main([TINY_CFG, '--work-dir', str(wd), '--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.count('Epoch [1/1]') == 2
    assert '[eval @ epoch 1] ' in out and 'mAP_0.25' in out
    assert 'image-feature cache' not in out
    ckpt = str(wd / 'checkpoints' / 'epoch_1.pth')
    metrics = eval_entry.main([TINY_CFG, ckpt, '--device', 'cpu'])
    assert {'mAP_0.25', 'mAP_0.50'} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    metrics = eval_entry.main([TINY_CFG, ckpt, '--device', 'cpu',
                               '--cfg-options', 'bf16=True'])
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize('policy', ['bf16=True', 'fp16.loss_scale=512.0'])
@pytest.mark.parametrize('config', ['imvotenet_tiny.py',
                                    'imvotenet_frcnn_tiny.py',
                                    'imvotenet_deform_tiny.py'])
def test_entry_points_train_imvotenet_under_the_policy(tmp_path, capsys,
                                                       config, policy):
    """ImVoteNet (fusion and image-only) and ``ImVoteNet_Deformdetr``'s
    fusion train through the train entry under the bf16 policy, selected
    either way the JAX package's ``train.py`` reads it (finite losses; a
    fusion's eval hook reaches an mAP), and a fusion's checkpoint is
    evaluated under it by the eval entry (the image-only model has no 2D
    mAP in either package)."""
    cfg = os.path.join(ROOT, 'demf_tpu_torch', 'configs', config)
    wd = tmp_path / 'wd'
    train.main([cfg, '--work-dir', str(wd), '--device', 'cpu',
                '--cfg-options', policy])
    out = capsys.readouterr().out
    assert 'compute dtype: bfloat16' in out and out.count('Epoch [1/1]') == 2
    assert 'nan' not in out.lower()
    if config != 'imvotenet_frcnn_tiny.py':
        assert '[eval @ epoch 1] ' in out
        metrics = eval_entry.main([cfg, str(wd / 'checkpoints' /
                                             'epoch_1.pth'),
                                   '--device', 'cpu', '--cfg-options',
                                   policy])
        assert all(np.isfinite(v) for v in metrics.values())


# -- under the bf16 policy ---------------------------------------------------

BRANCH_OUTPUTS = ('img_neck', 'img_rpn_head')


def _floats(tree):
    """The float32 numpy leaves of a nested output, in order."""
    return [np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)
            for x in jax.tree_util.tree_leaves(
                tree, is_leaf=torch.is_tensor)]


@pytest.fixture(scope='module')
def bf16_pair(pair):
    """The eval forward and one train step under the bf16 policy in both
    packages, from ``pair``'s weights, batch and draws: JAX's as
    ``make_eval_step`` / ``make_train_step`` run them under
    ``compute_dtype='bfloat16'``, the port's through ``make_eval_step`` and
    the ``TrainStep`` of a config with ``bf16=True``.  The image branch's
    FPN levels and RPN maps of the eval forward in both packages and both
    dtypes.  bf16 ties in the RPN's scores let each run keep other
    proposals, so the port's towers take JAX's bf16 2D boxes (and, in
    training, its half-drop)."""
    cfg, jmodel = pair['cfg'], pair['jmodel']
    params, stats, batch, draws = (pair['params'], pair['stats'],
                                   pair['batch'], pair['draws'])
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstats = unflatten_params(stats)

    def apply(p, b, dtype, **kw):
        if dtype is not None:
            p = jprec.cast_floating(p, dtype)
            b = jprec.cast_batch(b, dtype)
        with jprec.compute_dtype_scope(dtype):
            return jmodel.apply({'params': p, 'batch_stats': jstats}, b,
                                **kw)

    with pytest.MonkeyPatch.context() as mp:
        fixed_draws(mp, draws)

        def loss_fn(p, b):
            results, _ = apply(p, b, jnp.bfloat16, train=True,
                               mutable=['batch_stats'],
                               rngs={'sample': jax.random.PRNGKey(1)})
            results = jprec.cast_floating(results, 'float32')
            losses = jmodel.loss(results, b)
            return sum(losses.values()), (results, losses)

        (total, (results, losses)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                unflatten_params(params), jbatch))

        @jax.jit
        def infer(p, b):
            out = {}
            for name, dtype in (('bf16', jnp.bfloat16), ('f32', None)):
                res, inter = apply(p, b, dtype, train=False,
                                   capture_intermediates=True,
                                   mutable=['intermediates'])
                out[name] = (jprec.cast_floating(res, 'float32'), {
                    k: inter['intermediates'][k]['__call__'][0]
                    for k in BRANCH_OUTPUTS})
            return out

        runs = jax.device_get(infer(unflatten_params(params), jbatch))
    eval_results, branch = runs['bf16']
    out = dict(jax=dict(results=results, losses=losses, total=total,
                        grads=flatten_params(grads),
                        eval_results=eval_results, branch=branch,
                        branch_f32=runs['f32'][1]))

    sd = state_dict_from_jax(params, stats)
    tbatch = batch_to_device(batch, 'cpu')
    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(sd, strict=True)
    seeds = torch.from_numpy(draws[(2, 96)])
    out['port'] = {}
    for name, dtype in (('branch', torch.bfloat16), ('branch_f32', None)):
        got = {}
        hooks = [getattr(model, k).register_forward_hook(
            lambda m, a, o, k=k: got.setdefault(k, o))
            for k in BRANCH_OUTPUTS]
        with torch.inference_mode():
            prec.policy_call(model, dtype, prec.cast_batch(tbatch, dtype),
                             draws=dict(seeds=seeds))
        for hook in hooks:
            hook.remove()
        out['port'][name] = got

    def jax_boxes(res):
        return lambda *a, **k: (torch.tensor(res['bboxes_2d']),
                                torch.tensor(res['bboxes_2d_valid']))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model, 'extract_bboxes_2d', jax_boxes(eval_results))
        with torch.inference_mode():
            res = prec.cast_floating(prec.policy_call(
                model, torch.bfloat16, prec.cast_batch(tbatch,
                                                       torch.bfloat16),
                draws=dict(seeds=seeds)), torch.float32)
    out['port'].update(eval_results=res, det=model.get_bboxes(res, tbatch))
    model, _, step = zoo.build_trainer(dict(model=cfg, bf16=True, **OPTIM),
                                       'cpu')
    assert step.compute_dtype == torch.bfloat16
    model.load_state_dict(sd, strict=True)
    model.extract_bboxes_2d = jax_boxes(results)
    forward = model.forward
    model.forward = lambda *a, **k: forward(*a, draws=dict(seeds=seeds),
                                            **k)
    captured = {}
    loss = model.loss
    model.loss = lambda r, b: (captured.update(r), loss(r, b))[1]
    out['port'].update(metrics=step(tbatch, torch.Generator()),
                       results=captured, model=model)
    return out


def test_bf16_image_branch_rounds_as_much_as_jax(bf16_pair):
    """The FPN levels and the RPN maps of the eval forward (ResNet-50 at
    full width in bf16): the port's bf16 - float32 gap against JAX's, map
    by map, within a factor of 3 of each other (seen 0.55 to 1.4), and
    the port's bf16 maps within twice JAX's gap of JAX's bf16 maps (seen
    at most 1.3 times; the float32 runs agree to 3e-6)."""
    port, want = bf16_pair['port'], bf16_pair['jax']
    compared = 0
    for key in BRANCH_OUTPUTS:
        for got, got32, w, w32 in zip(
                _floats(port['branch'][key]), _floats(port['branch_f32'][key]),
                _floats(want['branch'][key]),
                _floats(want['branch_f32'][key])):
            gap = _rel(w, w32)
            assert 1 / 3 <= _rel(got, got32) / gap <= 3, key
            assert _rel(got, w) <= 2 * gap, key
            compared += 1
    assert compared == 5 + 2 * 5


def test_bf16_eval_forward_matches_jax(bf16_pair):
    """On JAX's bf16 2D boxes each tower's predictions within 2e-2 of the
    tensor's largest (seen 1.2e-2; JAX's own bf16 - float32 gap up to
    6.5e-2), the seeds equal, the detections float32 and finite."""
    got, want = bf16_pair['port'], bf16_pair['jax']
    assert got['eval_results']['bboxes_2d_valid'].any()
    check_towers(got['eval_results'], want['eval_results'], 2e-2)
    det = got['det']
    assert det['boxes_3d'].dtype == torch.float32
    assert torch.isfinite(det['boxes_3d']).all() and det['valid'].any()


def test_bf16_train_step_matches_jax(pair, bf16_pair):
    """One stage-2 step under the policy on JAX's bf16 2D boxes (after its
    half-drop): each loss term within 3e-2 relative of JAX's bf16 step
    (seen 1.1e-2), each trained tensor's gradient (before the clip) within
    twice JAX's own bf16 - float32 gap of JAX's bf16 gradient (train-mode
    BatchNorm on 32 seeds makes that gap large), the master weights and
    their gradients float32 and the 2D branch untouched."""
    got, want = bf16_pair['port'], bf16_pair['jax']
    metrics, model = got['metrics'], got['model']
    assert set(want['losses']) == set(metrics) - {'loss', 'grad_norm'}
    for key, w in want['losses'].items():
        assert _rel(metrics[key], w) < 3e-2, key
    branch = ('img_backbone', 'img_neck', 'img_rpn_head', 'img_roi_head')
    grads, grads32 = (state_dict_from_jax(
        {k: v for k, v in g.items() if not k.startswith(branch)}, {})
        for g in (want['grads'], pair['jax']['grads']))
    # the port's gradients before the clip at 10 (its scale follows the
    # norm, which the noisiest tensors set)
    unclip = 1 / min(1.0, 10.0 / metrics['grad_norm'].item())
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    assert set(grads) == set(params)
    largest = max(np.abs(w.numpy()).max() for w in grads.values())
    compared = 0
    for name, p in params.items():
        w, w32 = grads[name].numpy(), grads32[name].numpy()
        g = p.grad.numpy() * unclip
        assert p.dtype == p.grad.dtype == torch.float32, name
        if np.abs(w).max() < 1e-6 * largest:       # a bias before a BN
            continue
        assert np.abs(g - w).max() <= 2 * np.abs(w - w32).max(), name
        compared += 1
    assert compared > 60
    for name, p in model.named_parameters():
        if name.startswith(model.img_branch):
            assert p.grad is None, name
