"""The stage-1 Deformable-DETR pretrain of the port against the JAX
package's, on the CPU, at the tiny config's size (ResNet-50 at full width, a
32-wide neck and head, 20 queries, 1 encoder and 2 decoder layers, 64x96
images).

The same weights (initialized on the JAX side, perturbed, carried over by
``state_dict_from_jax``), running statistics and batch go through both.
MSDA runs in fp32 on the JAX side (``DEMF_TPU_MSDA_F32=1``); the port takes
its plain kernels.  Bounds: losses, GIoU and box conversions 1e-6; the
head's outputs 1e-5 absolute; each loss term 1e-4 relative; each gradient
within 1e-3 of that tensor's largest on the JAX side; boxes from
``get_bboxes`` 1e-4 of the image's size; AdamW with the 0.1 multipliers and
the 0.1 clip over two steps 1e-6 relative.
"""
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detector)
from demf_tpu.engine import optim as joptim
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.models import detr_head as jdetr
from demf_tpu.models import losses as jlosses
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu.zoo import load_model_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import (batch_to_device, build_optimizer,
                                   clip_grad_global_norm, set_lr,
                                   state_dict_from_jax, step_lr_schedule)
from demf_tpu_torch.models import detr_head, losses

TINY = load_model_cfg('synthetic/detr_pretrain_tiny.py')
BATCH = dict(b=2, hw=(64, 96), g=5, seed=3)
MAX_NORM = TINY.optimizer_config['grad_clip']['max_norm']


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The module on one intra-op thread: the tiny models' many small ops
    under the other test workers' threads slow by tens to hundreds of
    times with torch's default pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FROZEN = ('img_backbone.conv1', 'img_backbone.bn1', 'img_backbone.layer1.')


def _plain(cfg):
    """A config as plain dicts and lists (tuples become lists)."""
    if isinstance(cfg, dict):
        return {k: _plain(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [_plain(v) for v in cfg]
    return cfg


def tiny_cfg(solver='scipy', dropout=0.0):
    """The tiny model with every dropout rate at ``dropout``."""
    cfg = copy.deepcopy(zoo.tiny_detr_model_cfg())
    t = cfg['img_bbox_head']['transformer']
    enc = t['encoder']['transformerlayers']
    enc['ffn_dropout'] = dropout
    enc['attn_cfgs']['dropout'] = dropout
    dec = t['decoder']['transformerlayers']
    dec['ffn_dropout'] = dropout
    dec['attn_cfgs'] = [dict(c, dropout=dropout) for c in dec['attn_cfgs']]
    cfg['train_cfg']['assigner']['solver'] = solver
    return cfg


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_tiny_model_cfg_equals_the_jax_config():
    assert _plain(zoo.tiny_detr_model_cfg()) == _plain(dict(TINY.model))


def test_synth_detr2d_batch_equals_jax():
    from demf_tpu.zoo import synth_detr2d_batch
    want = jax.tree_util.tree_map(np.asarray, synth_detr2d_batch(**BATCH))
    got = zoo.synth_detr2d_batch(**BATCH)
    assert set(got) == set(want)
    for key in ('img', 'gt_bboxes', 'gt_labels', 'gt_bboxes_valid'):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got['img_meta']['img_shape'],
                                  want['img_meta']['img_shape'])


# -- losses and box functions -------------------------------------------

def _boxes(rng, n):
    xy = rng.rand(n, 2) * 50
    return np.concatenate([xy, xy + rng.rand(n, 2) * 40 + 1], -1).astype(
        np.float32)


@pytest.mark.parametrize('reduction,avg', [('mean', None), ('mean', 3.5),
                                           ('sum', None), ('none', None)])
def test_focal_loss_matches_jax(reduction, avg):
    rng = np.random.RandomState(0)
    pred = rng.randn(40, 10).astype(np.float32) * 3
    target = rng.randint(0, 11, 40)              # 10 = background
    kw = dict(gamma=2.0, alpha=0.25, reduction=reduction, loss_weight=2.0)
    want = jlosses.FocalLoss(**kw)(jnp.asarray(pred), jnp.asarray(target),
                                   avg_factor=avg)
    got = losses.FocalLoss(**kw)(torch.from_numpy(pred),
                                 torch.from_numpy(target), avg_factor=avg)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize('weighted', [False, True])
def test_giou_loss_matches_jax(weighted):
    rng = np.random.RandomState(1)
    pred, target = _boxes(rng, 30), _boxes(rng, 30)
    pred[:3] = target[:3]                        # GIoU 1
    pred[3:6, :2] += 200
    pred[3:6, 2:] += 200                         # disjoint
    w = (rng.rand(30) < 0.5).astype(np.float32) if weighted else None
    want = jlosses.GIoULoss(loss_weight=2.0)(
        jnp.asarray(pred), jnp.asarray(target),
        weight=None if w is None else jnp.asarray(w), avg_factor=7.0)
    got = losses.GIoULoss(loss_weight=2.0)(
        torch.from_numpy(pred), torch.from_numpy(target),
        weight=None if w is None else torch.from_numpy(w), avg_factor=7.0)
    assert _rel(got, want) < 1e-6


def test_giou_matrix_and_box_conversions_match_jax():
    rng = np.random.RandomState(2)
    a, b = _boxes(rng, 12), _boxes(rng, 7)
    assert _rel(detr_head.giou_2d(torch.from_numpy(a), torch.from_numpy(b)),
                jdetr.giou_2d(jnp.asarray(a), jnp.asarray(b))) < 1e-6
    batched = detr_head.giou_2d(torch.from_numpy(np.stack([a, a[::-1]])),
                                torch.from_numpy(b))
    assert tuple(batched.shape) == (2, 12, 7)
    cxcywh = detr_head.box_xyxy_to_cxcywh(torch.from_numpy(a))
    assert _rel(cxcywh, jdetr.box_xyxy_to_cxcywh(jnp.asarray(a))) < 1e-6
    assert _rel(detr_head.box_cxcywh_to_xyxy(cxcywh), a) < 1e-6
    x = rng.rand(50).astype(np.float32)
    x[:2] = (0.0, 1.0)
    assert _rel(detr_head.inverse_sigmoid(torch.from_numpy(x)),
                jdetr.inverse_sigmoid(jnp.asarray(x))) < 1e-6


# -- the model ------------------------------------------------------------

def _jax_variables(jmodel, jbatch):
    """Initialized, then perturbed: params + 0.02 N(0, 1), random running
    statistics (flat dicts)."""
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(0)
    params = {k: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) *
              0.02 for k, v in flatten_params(variables['params']).items()}
    stats = {k: (rng.randn(*v.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
             for k, v in flatten_params(variables['batch_stats']).items()}
    return params, stats


@pytest.fixture(scope='module')
def pair():
    """The two models with the same weights: (JAX model, its variables,
    the batch as jax arrays, the port's model, the batch as tensors)."""
    cfg = tiny_cfg()
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = zoo.synth_detr2d_batch(**BATCH)
    batch['img_meta']['img_shape'][1] = (56, 80)     # one padded image
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = _jax_variables(jmodel, jbatch)
    jvars = {'params': unflatten_params(params),
             'batch_stats': unflatten_params(stats)}
    model = zoo.build_detector(cfg, 'cpu')
    sd = state_dict_from_jax(params, stats)
    model.load_state_dict(sd, strict=True)
    return dict(cfg=cfg, jmodel=jmodel, jvars=jvars, jbatch=jbatch,
                params=params, stats=stats, model=model, sd=sd,
                batch=batch_to_device(batch, 'cpu'))


def test_state_dict_from_jax_is_strict_both_ways(pair):
    """Every flax leaf lands on a key of the port's model and every key of
    the model (but BatchNorm's batch counters) comes from a flax leaf."""
    want = pair['model'].state_dict()
    assert set(pair['sd']) == set(want)
    counters = [k for k in want if k.endswith('num_batches_tracked')]
    for key, v in pair['sd'].items():
        if key not in counters:
            assert tuple(v.shape) == tuple(want[key].shape), key
    # a decoder layer's query / key / value kernels and biases (6 leaves)
    # become in_proj_weight and in_proj_bias (2 keys)
    assert len(pair['sd']) - len(counters) == \
        len(pair['params']) + len(pair['stats']) - 4 * 2
    head = [k for k in want if k.startswith('img_bbox_head.')]
    for part in ('transformer.level_embeds', 'query_embedding.weight',
                 'transformer.reference_points.weight',
                 'transformer.encoder.layers.0.attentions.0.value_proj.bias',
                 'transformer.decoder.layers.1.attentions.0.attn.in_proj_bias',
                 'transformer.decoder.layers.1.norms.2.weight',
                 'fc_cls.bias', 'fc_reg.4.weight'):
        assert f'img_bbox_head.{part}' in head, part


@pytest.fixture(scope='module')
def forward_pair(pair):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        want = jax.device_get(jax.jit(lambda v, b: pair['jmodel'].apply(
            v, b, train=False))(pair['jvars'], pair['jbatch']))['img_preds']
    with torch.no_grad():
        got = pair['model'].eval()(pair['batch'])['img_preds']
    return got, want


def test_head_forward_matches_jax(forward_pair):
    got, want = forward_pair
    assert tuple(got['cls_scores'].shape) == (2, 2, 20, 10)
    assert tuple(got['bbox_preds'].shape) == (2, 2, 20, 4)
    for key in ('cls_scores', 'bbox_preds'):
        err = np.abs(got[key].numpy() - np.asarray(want[key])).max()
        assert err < 1e-5, (key, err)


@pytest.mark.parametrize('solver', ['scipy', 'auction'])
def test_head_loss_matches_jax(pair, forward_pair, solver):
    """On the same predictions: the same assignment (scipy: the optimum on
    both sides; auction: the same steps), so the same losses."""
    _, want_preds = forward_pair
    cfg = tiny_cfg(solver)
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    want = jax.device_get(jmodel.loss({'img_preds': want_preds},
                                      pair['jbatch']))
    model = zoo.build_detector(cfg, 'cpu')
    preds = {k: torch.from_numpy(np.asarray(v))
             for k, v in want_preds.items()}
    got = model.loss({'img_preds': preds}, pair['batch'])
    assert list(got) == ['loss_cls.d0', 'loss_bbox.d0', 'loss_iou.d0',
                         'loss_cls', 'loss_bbox', 'loss_iou']
    assert set(got) == set(want)
    for key, w in want.items():
        assert float(w) > 0, key
        assert _rel(got[key], w) < 1e-4, key


def test_get_bboxes_matches_jax(pair, forward_pair):
    _, want_preds = forward_pair
    want = jax.device_get(pair['jmodel'].get_bboxes(
        {'img_preds': want_preds}, pair['jbatch']))
    preds = {k: torch.from_numpy(np.asarray(v))
             for k, v in want_preds.items()}
    got = pair['model'].get_bboxes({'img_preds': preds}, pair['batch'])
    assert tuple(got['bboxes'].shape) == (2, 20, 5)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    assert np.abs(got['bboxes'].numpy() -
                  np.asarray(want['bboxes'])).max() < 1e-4 * 96


def test_fusion_mode_is_refused(pair):
    """The stage-1 model has no point branch: a batch with points is
    refused (the fusion mode itself is held in test_torch_imvotenet.py)."""
    batch = dict(pair['batch'], points=torch.zeros(2, 16, 4))
    with pytest.raises(ValueError, match='fusion mode'):
        pair['model'](batch)


@pytest.fixture(scope='module')
def step_pair(pair):
    """One train step from the same weights: JAX (losses, gradients, their
    norm) and the port's (metrics, the model after the step, the frozen
    tensors before it, the optimizer)."""
    jmodel, jvars, jbatch = pair['jmodel'], pair['jvars'], pair['jbatch']
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')

        def loss_fn(p):
            results = jmodel.apply(
                {'params': p, 'batch_stats': jvars['batch_stats']}, jbatch,
                train=True, rngs={'dropout': jax.random.PRNGKey(2)})
            losses = jmodel.loss(results, jbatch)
            return sum(losses.values()), losses

        (total, jlosses_), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jvars['params']))
    jax_out = dict(total=total, losses=jlosses_, grads=flatten_params(grads),
                   grad_norm=float(optax.global_norm(grads)))
    model, optimizer, step = zoo.build_trainer(
        dict(model=pair['cfg'], optimizer=TINY.optimizer,
             optimizer_config=TINY.optimizer_config,
             lr_config=TINY.lr_config), 'cpu')
    model.load_state_dict(pair['sd'], strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    # oneDNN's float32 convolution backward (Winograd for the 3x3 kernels)
    # is off by 3e-3 of a tensor's largest in layer3's gradients against a
    # float64 run; PyTorch's own kernels agree with it, and with the JAX
    # package, at 3e-6
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = step(pair['batch'], torch.Generator().manual_seed(0))
    return jax_out, metrics, model, before, optimizer


def test_pretrain_step_losses_match_jax(step_pair):
    jax_out, metrics, _, _, _ = step_pair
    want = jax_out['losses']
    assert set(metrics) == set(want) | {'loss', 'grad_norm'}
    for key, w in want.items():
        assert _rel(metrics[key], w) < 1e-4, key
    assert _rel(metrics['loss'], jax_out['total']) < 1e-4
    assert _rel(metrics['grad_norm'], jax_out['grad_norm']) < 1e-4


def test_pretrain_step_grads_match_jax(step_pair):
    """The port's gradients are clipped after the step, so the JAX ones are
    scaled by the same factor.  The stem and ``layer1`` (``frozen_stages``
    1) have no gradient in the port and a zero one in the JAX package."""
    jax_out, _, model, _, _ = step_pair
    norm = jax_out['grad_norm']
    assert norm >= MAX_NORM                    # the clip is active
    scale = MAX_NORM / norm
    want = state_dict_from_jax(jax_out['grads'], {})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    compared = frozen = 0
    for name, p in params.items():
        w = want[name].numpy() * scale
        if name.startswith(FROZEN):
            assert not p.requires_grad and p.grad is None, name
            assert not np.any(w), name
            frozen += 1
            continue
        assert p.requires_grad, name
        err = np.abs(p.grad.numpy() - w).max()
        assert np.abs(w).max() > 0, name
        assert err <= 1e-3 * np.abs(w).max(), (name, err, np.abs(w).max())
        compared += 1
    assert frozen == 33 and compared > 200


def test_pretrain_step_moves_all_but_the_frozen_stages(step_pair):
    _, _, model, before, _ = step_pair
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), before[name])
        assert same == name.startswith(FROZEN), name
    assert not model.img_backbone.layer2[0].bn1.training    # norm_eval
    assert model.img_bbox_head.training


def test_pretrain_step_keeps_no_optimizer_state_for_the_frozen_stages(
        step_pair):
    """The frozen stem and ``layer1`` stay in AdamW's groups (the saved
    optimizer's layout does not depend on ``frozen_stages``), but a tensor
    without a gradient is skipped: after a step it has no moments, and
    every trained tensor has."""
    _, _, model, _, optimizer = step_pair
    grouped = {id(p) for g in optimizer.param_groups for p in g['params']}
    frozen = 0
    for name, p in model.named_parameters():
        assert id(p) in grouped, name
        if name.startswith(FROZEN):
            assert p not in optimizer.state, name
            frozen += 1
        else:
            assert optimizer.state[p]['step'] == 1, name
    assert frozen == 33


def test_adamw_groups_and_clip_match_optax_over_two_steps(pair):
    """The same gradient trees through the JAX package's optax chain and
    the port's AdamW + clip with this config's ``custom_keys``: the backbone,
    the MSDA layers' ``sampling_offsets`` and the head's reference points at
    0.1 of the rate, by substring on either tree's names."""
    rng = np.random.RandomState(5)
    params = {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in pair['params'].items()}
    frozen = {k for k in params if k.startswith(
        ('img_backbone/conv1', 'img_backbone/bn1', 'img_backbone/layer1_'))}

    def grads_tree():
        return {k: (np.zeros_like(v) if k in frozen else
                    rng.randn(*v.shape).astype(np.float32))
                for k, v in params.items()}

    grads = [grads_tree(), grads_tree()]
    sched = dict(base_lr=TINY.optimizer['lr'], steps_per_epoch=1,
                 milestones=[1])
    tx = joptim.build_optimizer(
        dict(TINY.optimizer), unflatten_params(params),
        lr_schedule=joptim.step_lr_schedule(**sched),
        grad_clip=dict(max_norm=MAX_NORM))
    jparams = unflatten_params(params)
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update(unflatten_params(g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    model = zoo.build_detector(pair['cfg'], 'cpu')
    model.load_state_dict(state_dict_from_jax(params, {}), strict=False)
    optimizer = build_optimizer(model, TINY.optimizer,
                                model.frozen_param_patterns())
    assert sorted(g['lr_mult'] for g in optimizer.param_groups) == [0.1, 1.0]
    slow = {id(p) for g in optimizer.param_groups if g['lr_mult'] == 0.1
            for p in g['params']}
    for name, p in model.named_parameters():
        key = any(k in name for k in ('backbone', 'sampling_offsets',
                                      'reference_points'))
        assert (id(p) in slow) == key, name
    schedule = step_lr_schedule(**sched)
    trained = [p for p in model.parameters() if p.requires_grad]
    for count, g in enumerate(grads):
        sd = state_dict_from_jax(g, {})
        for name, p in model.named_parameters():
            p.grad = sd[name].clone() if p.requires_grad else None
        clip_grad_global_norm(trained, MAX_NORM)
        set_lr(optimizer, schedule(count))
        optimizer.step()
    want = state_dict_from_jax(flatten_params(jparams), {})
    for name, p in model.named_parameters():
        assert _rel(p.detach(), want[name]) < 1e-6, name
