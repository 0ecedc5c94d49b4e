"""The port's stage-2 training step against the JAX package's, on the CPU.

A tiny DeMF-VoteNet (``demf_tpu.zoo.tiny_demf_model_cfg`` with exact ball
query, every dropout rate 0, proposals sampled at the seeds) takes one
train step on cached image features from the same weights, BatchNorm
statistics and batch on both sides: the JAX loss and gradients come from
``jax.value_and_grad`` of ``model.apply(train=True)`` + ``model.loss``, the
port's from ``zoo.build_trainer``'s train step.  MSDA runs in fp32 on the
JAX side (``DEMF_TPU_MSDA_F32=1``).

Bounds: losses and the gradient norm within 1e-4 relative; each
parameter's gradient within 1e-3 of the largest |gradient| of that tensor
on the JAX side; the updated BatchNorm running statistics within 1e-5
relative.  The optimizer alone (clip, AdamW, lr_mult, frozen patterns and
the step schedule) agrees with the optax chain within 1e-6 relative over
two steps.  With ``freeze_img_branch=False`` the step runs from the image:
the backbone's ``frozen_stages`` keep the stem and ``layer1`` still, and
every other gradient of the image branch agrees at the same bound.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detector)
from demf_tpu.engine import optim as joptim
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu.zoo import load_model_cfg, tiny_demf_model_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import (batch_to_device, build_optimizer,
                                   clip_grad_global_norm, set_lr,
                                   state_dict_from_jax, step_lr_schedule)

BATCH = dict(b=2, p=2048, g=16, hw=(64, 96), valid_hw=(60, 88), seed=1)
FULL = load_model_cfg('demf/demf_votenet.py')
MAX_NORM = FULL.optimizer_config['grad_clip']['max_norm']
IMG_BRANCH = ('img_backbone', 'img_neck', 'img_encoder')


def tiny_train_cfg(dropout=0.0):
    """The tiny model with exact ball query, the given dropout everywhere
    in the decoder, and distance thresholds wide enough that the tiny
    model's 16 proposals include positives."""
    cfg = tiny_demf_model_cfg()
    cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    head = cfg['pts_bbox_head']
    head['vote_aggregation_cfg']['ball_query_exact'] = True
    tl = head['decoder']['transformerlayers']
    tl['ffn_dropout'] = dropout
    tl['attn_cfgs'] = [dict(c, dropout=dropout) for c in tl['attn_cfgs']]
    cfg['train_cfg']['pts'].update(pos_distance_thr=1.5,
                                   neg_distance_thr=2.5)
    return cfg


def tiny_batch():
    """``synth_demf_batch`` with GT boxes three times the size, so that
    points and proposals fall in them."""
    batch = zoo.synth_demf_batch(**BATCH)
    batch['gt_bboxes_3d'][..., 3:6] *= 3
    return batch


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


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
def step_pair():
    """JAX (losses, grads, new batch stats, grad norm) and the port's
    (metrics, model after the step, image-branch params before it)."""
    cfg = tiny_train_cfg()
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = tiny_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = _jax_variables(jmodel, jbatch)
    jvars = {'params': unflatten_params(params),
             'batch_stats': unflatten_params(stats)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        feats = jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False, img_feat_only=True))(jvars, jbatch)
        cached = {k: v for k, v in batch.items() if k != 'img'}
        cached['img_features'] = tuple(np.asarray(f) for f in feats)
        jcached = jax.tree_util.tree_map(jnp.asarray, cached)

        def loss_fn(p):
            results, mutated = jmodel.apply(
                {'params': p, 'batch_stats': jvars['batch_stats']}, jcached,
                train=True, mutable=['batch_stats'],
                rngs={'sample': jax.random.PRNGKey(1),
                      'dropout': jax.random.PRNGKey(2)})
            losses = jmodel.loss(results, jcached)
            return sum(losses.values()), (losses, mutated['batch_stats'])

        (total, (losses, new_bs)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jvars['params']))
    jax_out = dict(total=total, losses=losses,
                   grads=flatten_params(grads),
                   batch_stats=flatten_params(new_bs),
                   grad_norm=float(optax.global_norm(grads)))

    model, _, step = zoo.build_trainer(
        dict(model=cfg, optimizer=FULL.optimizer,
             optimizer_config=FULL.optimizer_config,
             lr_config=FULL.lr_config), 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    img_before = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n.startswith(IMG_BRANCH)}
    metrics = step(batch_to_device(cached, 'cpu'),
                   torch.Generator().manual_seed(0))
    return jax_out, metrics, model, img_before


def test_train_step_losses_match_jax(step_pair):
    jax_out, metrics, _, _ = step_pair
    want = jax_out['losses']
    assert set(metrics) == set(want) | {'loss', 'grad_norm'}
    for key, w in want.items():
        assert float(w) > 0, key          # every term is exercised
        assert _rel(metrics[key], w) < 1e-4, key
    assert _rel(metrics['loss'], jax_out['total']) < 1e-4
    assert _rel(metrics['grad_norm'], jax_out['grad_norm']) < 1e-4


def test_train_step_grads_match_jax(step_pair):
    """After the step the port's gradients are clipped (optax's rule), so
    the JAX gradients are scaled by the same factor before comparing.

    A bias that feeds a train-mode BatchNorm, directly or through a linear
    layer (the heads' shared convs, the position embedding, the decoder's
    last LayerNorm), has a zero gradient in exact arithmetic: the batch
    mean takes its shift out again.  Such a tensor holds rounding noise on
    both sides, so where the JAX gradient is below 1e-6 of the step's
    largest, the port's must be too."""
    jax_out, _, model, _ = step_pair
    norm = jax_out['grad_norm']
    assert norm >= MAX_NORM                    # the clip is active
    scale = MAX_NORM / norm
    want = state_dict_from_jax(jax_out['grads'], {})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    largest = max(np.abs(w.numpy()).max() for w in want.values()) * scale
    compared = 0
    for name, p in params.items():
        w = want[name].numpy() * scale
        if name.startswith(IMG_BRANCH):
            assert p.grad is None and not np.any(w), name
            continue
        got = p.grad.numpy()
        if np.abs(w).max() < 1e-6 * largest:
            assert np.abs(got).max() < 1e-6 * largest, name
            continue
        err = np.abs(got - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (name, err, np.abs(w).max())
        compared += 1
    assert compared > 50


def test_train_step_batch_stats_match_jax(step_pair):
    jax_out, _, model, _ = step_pair
    want = state_dict_from_jax({}, jax_out['batch_stats'])
    got = model.state_dict()
    assert want
    for key, w in want.items():
        if key.endswith(('running_mean', 'running_var')):
            assert _rel(got[key], w) < 1e-5, key


def test_train_step_keeps_frozen_image_branch(step_pair):
    _, _, model, img_before = step_pair
    assert img_before
    for name, p in model.named_parameters():
        if name in img_before:
            assert not p.requires_grad
            assert torch.equal(p, img_before[name]), name
    for name in IMG_BRANCH:
        assert not getattr(model, name).training
    assert model.pts_bbox_head.training


@pytest.mark.parametrize('warmup', [None, 'linear'])
def test_step_lr_schedule_matches_jax(warmup):
    kw = dict(warmup=warmup, warmup_iters=7, warmup_ratio=0.25)
    got = step_lr_schedule(0.008, 3, [2, 4], **kw)
    want = joptim.step_lr_schedule(0.008, 3, [2, 4], **kw)
    for count in range(16):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, err_msg=str(count))


def test_adamw_matches_optax_chain_over_two_steps():
    """The same gradient trees through the optax chain of
    ``demf_tpu.engine.optim.build_optimizer`` and through the port's AdamW
    + clip: decoder at lr_mult 0.05, the image branch frozen (zero
    gradients on the JAX side), the clip active, and a schedule that drops
    the rate after the first step."""
    cfg = tiny_train_cfg()
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = jax.tree_util.tree_map(jnp.asarray, tiny_batch())
    shapes = jax.eval_shape(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False), batch)
    rng = np.random.RandomState(5)
    params = {k: rng.randn(*s.shape).astype(np.float32) for k, s in
              flatten_params(shapes['params']).items()}

    def grads_tree():
        return {k: (np.zeros_like(v) if k.startswith(IMG_BRANCH) else
                    rng.randn(*v.shape).astype(np.float32))
                for k, v in params.items()}

    grads = [grads_tree(), grads_tree()]
    opt_cfg = dict(FULL.optimizer)
    pw = dict(opt_cfg['paramwise_cfg'])
    pw['custom_keys'] = dict(pw['custom_keys'], **{
        k: dict(lr_mult=0.0, decay_mult=0.0) for k in IMG_BRANCH})
    sched = dict(base_lr=opt_cfg['lr'], steps_per_epoch=1, milestones=[1])
    tx = joptim.build_optimizer(
        dict(opt_cfg, paramwise_cfg=pw), unflatten_params(params),
        lr_schedule=joptim.step_lr_schedule(**sched),
        grad_clip=dict(max_norm=MAX_NORM))
    jparams = unflatten_params(params)
    state = tx.init(jparams)
    for g in grads:
        assert float(optax.global_norm(g)) > MAX_NORM
        updates, state = tx.update(unflatten_params(g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, {}), strict=False)
    optimizer = build_optimizer(model, FULL.optimizer,
                                model.frozen_param_patterns())
    assert sorted(g['lr_mult'] for g in optimizer.param_groups) == \
        [0.0, 0.05, 1.0]
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


# -- the image branch trained too (``freeze_img_branch=False``) -------------

FROZEN_STAGES = ('img_backbone.conv1', 'img_backbone.bn1',
                 'img_backbone.layer1.')


@pytest.fixture(scope='module')
def unfrozen_pair():
    """One step of the tiny model with a trainable image branch, from the
    image itself (nothing is cached): JAX (gradients, their norm) and the
    port's (the model after the step, every parameter before it)."""
    cfg = tiny_train_cfg()
    cfg['freeze_img_branch'] = False
    tl = cfg['img_encoder']['encoder']['transformerlayers']
    tl['ffn_dropout'] = 0.0
    tl['attn_cfgs'] = dict(tl['attn_cfgs'], dropout=0.0)
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = tiny_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = _jax_variables(jmodel, jbatch)
    jvars = {'params': unflatten_params(params),
             'batch_stats': unflatten_params(stats)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')

        def loss_fn(p):
            results, _ = jmodel.apply(
                {'params': p, 'batch_stats': jvars['batch_stats']}, jbatch,
                train=True, mutable=['batch_stats'],
                rngs={'sample': jax.random.PRNGKey(1),
                      'dropout': jax.random.PRNGKey(2)})
            return sum(jmodel.loss(results, jbatch).values())

        total, grads = jax.device_get(jax.jit(jax.value_and_grad(loss_fn))(
            jvars['params']))
    model, _, step = zoo.build_trainer(
        dict(model=cfg, optimizer=FULL.optimizer,
             optimizer_config=FULL.optimizer_config,
             lr_config=FULL.lr_config), 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    # PyTorch's own convolutions: oneDNN's float32 backward is off by 3e-3
    # of a tensor's largest against a float64 run
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = step(batch_to_device(batch, 'cpu'),
                       torch.Generator().manual_seed(0))
    return (dict(total=total, grads=flatten_params(grads),
                 grad_norm=float(optax.global_norm(grads))),
            metrics, model, before)


def test_unfrozen_image_branch_grads_match_jax(unfrozen_pair):
    """``frozen_stages=1`` of the backbone holds with the branch trained:
    the stem and ``layer1`` have no gradient in the port (and a zero one in
    the JAX package, which stops it at their outputs); ``layer2`` on, the
    neck and the encoder get the JAX package's gradients."""
    jax_out, metrics, model, _ = unfrozen_pair
    assert _rel(metrics['loss'], jax_out['total']) < 1e-4
    assert _rel(metrics['grad_norm'], jax_out['grad_norm']) < 1e-4
    scale = MAX_NORM / jax_out['grad_norm']
    assert scale <= 1
    want = state_dict_from_jax(jax_out['grads'], {})
    largest = max(np.abs(w.numpy()).max() for w in want.values()) * scale
    compared = {}
    for name, p in model.named_parameters():
        w = want[name].numpy() * scale
        if name.startswith(FROZEN_STAGES):
            assert not p.requires_grad and p.grad is None, name
            assert not np.any(w), name
            continue
        assert p.requires_grad, name
        if np.abs(w).max() < 1e-6 * largest:     # see the frozen case above
            assert np.abs(p.grad.numpy()).max() < 1e-6 * largest, name
            continue
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (name, err, np.abs(w).max())
        compared[name.split('.')[0]] = compared.get(name.split('.')[0], 0) + 1
    assert compared['img_backbone'] > 100 and compared['img_neck'] >= 8
    assert compared['img_encoder'] > 20 and compared['pts_bbox_head'] > 50


def test_unfrozen_image_branch_step_keeps_the_frozen_stages(unfrozen_pair):
    _, _, model, before = unfrozen_pair
    assert model.frozen_param_patterns() == []
    assert model.img_backbone.frozen_param_patterns() == [
        'conv1', 'bn1', 'layer1.']
    frozen = moved = 0
    for name, p in model.named_parameters():
        if name.startswith(FROZEN_STAGES):
            assert torch.equal(p.detach(), before[name]), name
            frozen += 1
        elif name.startswith(IMG_BRANCH):
            moved += not torch.equal(p.detach(), before[name])
    assert frozen == 33 and moved > 150
    assert model.img_encoder.training and model.img_neck.training
    assert not model.img_backbone.layer2[0].bn1.training      # norm_eval
