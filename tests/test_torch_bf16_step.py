"""The port's stage-2 train step under the bf16 policy against the JAX
package's, on the CPU.

The tiny DeMF-VoteNet of ``tests/test_torch_train_step.py`` (exact ball
query, dropout 0, proposals at the seeds, cached image features) takes one
train step from the same weights, BatchNorm statistics and batch.  The JAX
side is ``demf_tpu/engine/trainer.py::make_train_step``'s loss under
``compute_dtype='bfloat16'``: bf16 copies of the parameters, the cached
features cast, the policy's scope, the results cast to float32 before
``model.loss``; the port's is ``zoo.build_trainer`` with ``bf16=True``.

What holds, and why.  This tiny model in train mode is chaotic under
bf16: BatchNorm on batch statistics of 2 scenes amplifies rounding, so in
either package the bf16 step's stage predictions differ from the float32
step's by 14-100% of each tensor's largest and most gradients by about
their own size (the JAX package's bf16 gradient norm is 1.8 times its
float32 one).  Against that:

* the BatchNorm running statistics hold within 3e-2 relative of JAX's;
* every loss within 0.1 relative of JAX's (the largest gap seen is
  4.7e-2, the center loss), and within 0.2 of the port's own float32 step,
  the bound of ``tests/test_engine.py``'s bf16 test of the JAX package;
* every gradient of the part before the decoder (point branch, vote
  module, aggregation, the first prediction stage) is at least twice as
  close to JAX's bf16 gradient as the float32 gradient is (seen: 0.03 to
  0.44 of the float32 gap): the port rounds where the JAX package rounds.
  A tensor whose three gradients all lie within 1e-3 of the largest
  gradient of each other (a bias that feeds a train-mode BatchNorm: zero
  in exact arithmetic) is rounding noise and not compared;
* the decoder and the second stage are chaotic here: the JAX package's
  bf16 MSDA rounds its bilinear corner weights and products to bf16, the
  port's (K3 / K4 and their plain version) keeps them float32, and the
  train-mode BatchNorm before them amplifies it, so their gradients differ
  from JAX's by up to twice their own size (the float32 step's too).  In
  the step they are held to 1.5e-3 of the step's largest gradient (seen:
  at most 8.6e-4; the float32 step's reach 2.9e-3 there, in
  ``conv_pred1``).  The decoder layer alone, with no BatchNorm before it,
  is held tensor by tensor (``test_bf16_decoder_layer_grads_match_jax``):
  every gradient within 8e-2 of its largest, the sampling offsets'
  within 0.25 (seen: 6.1e-2 and 0.165), and closer to JAX's than the
  float32 layer's in at least 90% of the tensors (seen: 29 of 30);
* master weights, gradients, optimizer state and running statistics are
  float32.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.models import transformer as jtr
from demf_tpu.utils import precision as jprec
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import batch_to_device, state_dict_from_jax
from demf_tpu_torch.models import transformer
from demf_tpu_torch.utils import precision as prec
from test_torch_modules import SHAPES, _carry
from test_torch_train_step import (FULL, IMG_BRANCH, MAX_NORM, _jax_variables,
                                   _rel, tiny_batch, tiny_train_cfg)


def _trainer(cfg, params, stats, bf16):
    run = dict(model=cfg, optimizer=FULL.optimizer,
               optimizer_config=FULL.optimizer_config,
               lr_config=FULL.lr_config)
    if bf16:
        run['bf16'] = True
    model, optimizer, step = zoo.build_trainer(run, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return model, optimizer, step


@pytest.fixture(scope='module')
def bf16_steps():
    """JAX (losses, grads, new batch stats, grad norm) under the policy;
    the port's bf16 step (metrics, model, optimizer) and its float32
    step's metrics."""
    cfg = tiny_train_cfg()
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = tiny_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = _jax_variables(jmodel, jbatch)
    jvars = {'params': unflatten_params(params),
             'batch_stats': unflatten_params(stats)}
    feats = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, img_feat_only=True))(jvars, jbatch)
    cached = {k: v for k, v in batch.items() if k != 'img'}
    cached['img_features'] = tuple(np.asarray(f) for f in feats)
    jcached = jax.tree_util.tree_map(jnp.asarray, cached)

    def loss_fn(p):
        with jprec.compute_dtype_scope('bfloat16'):
            results, mutated = jmodel.apply(
                {'params': jprec.cast_floating(p, jnp.bfloat16),
                 'batch_stats': jvars['batch_stats']},
                jprec.cast_batch(jcached, jnp.bfloat16), train=True,
                mutable=['batch_stats'],
                rngs={'sample': jax.random.PRNGKey(1),
                      'dropout': jax.random.PRNGKey(2)})
        results = jprec.cast_floating(results, 'float32')
        losses = jmodel.loss(results, jcached)
        return sum(losses.values()), (losses, mutated['batch_stats'])

    (total, (losses, new_bs)), grads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jvars['params']))
    jax_out = dict(total=total, losses=losses, grads=flatten_params(grads),
                   batch_stats=flatten_params(new_bs),
                   grad_norm=float(optax.global_norm(grads)))
    tcached = batch_to_device(cached, 'cpu')
    model, optimizer, step = _trainer(cfg, params, stats, bf16=True)
    assert step.compute_dtype == torch.bfloat16
    metrics = step(tcached, torch.Generator().manual_seed(0))
    model32, _, step32 = _trainer(cfg, params, stats, bf16=False)
    assert step32.compute_dtype is None
    metrics32 = step32(tcached, torch.Generator().manual_seed(0))
    return jax_out, metrics, model, optimizer, (metrics32, model32)


def test_bf16_step_losses_match_jax(bf16_steps):
    jax_out, metrics, _, _, _ = bf16_steps
    want = jax_out['losses']
    assert set(metrics) == set(want) | {'loss', 'grad_norm'}
    for key, w in want.items():
        assert float(w) > 0, key
        assert metrics[key].dtype == torch.float32
        assert _rel(metrics[key], w) < 0.1, key
    assert _rel(metrics['loss'], jax_out['total']) < 0.1


DECODER = ('pts_bbox_head.decoder', 'pts_bbox_head.conv_pred1')
DECODER_STEP_LIMIT = 1.5e-3     # of the step's largest gradient


def test_bf16_step_grads_follow_jax_before_the_decoder(bf16_steps):
    """Both steps clip, the port's by its own norm: each side's gradients
    are compared unclipped.  The decoder's are held to
    ``DECODER_STEP_LIMIT`` of the largest gradient (see the module's
    docstring), a limit the float32 step breaks."""
    jax_out, metrics, model, _, (metrics32, model32) = bf16_steps
    want = state_dict_from_jax(jax_out['grads'], {})
    unclip = [max(float(m['grad_norm']) / MAX_NORM, 1.0)
              for m in (metrics, metrics32)]
    fp32 = dict(model32.named_parameters())
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    compared = decoder = 0
    decoder32 = []
    for name, p in model.named_parameters():
        if name.startswith(IMG_BRANCH):
            assert p.grad is None, name
            continue
        assert p.dtype == p.grad.dtype == torch.float32, name
        got = p.grad.numpy() * unclip[0]
        assert np.isfinite(got).all(), name
        w = want[name].numpy()
        g32 = fp32[name].grad.numpy() * unclip[1]
        err, err32 = np.abs(got - w).max(), np.abs(g32 - w).max()
        if name.startswith(DECODER):
            assert err <= DECODER_STEP_LIMIT * largest, (name, err / largest)
            decoder32.append(err32 / largest)
            decoder += 1
            continue
        if max(err, err32) < 1e-3 * largest:
            continue        # rounding noise on all three sides
        assert err <= 0.5 * err32, (name, err, err32)
        compared += 1
    assert compared > 50
    assert decoder == 40
    assert max(decoder32) > DECODER_STEP_LIMIT


def test_bf16_decoder_layer_grads_match_jax(monkeypatch):
    """The tiny DeMF decoder layer alone under each package's policy, in
    eval mode: bf16 query and image features as the head hands them over,
    float32 positions, reference points and ratios; the JAX MSDA on its
    bf16 gather planes.  Output within 2e-2 of its largest (seen 9.3e-3);
    the gradients of every parameter and of query and value as the
    module's docstring states, against the same layer in float32 on the
    same (bf16-rounded) inputs."""
    monkeypatch.delenv('DEMF_TPU_MSDA_F32', raising=False)
    cfg = dict(tiny_train_cfg()['pts_bbox_head']['decoder'])
    cfg.pop('type')
    rng = np.random.RandomState(5)
    s = sum(h * w for h, w in SHAPES)
    masks = jtr.make_level_masks(jnp.asarray(np.array(
        [[60, 88], [64, 72]], np.int32)), (64, 96), SHAPES)
    query = jnp.asarray(rng.randn(2, 16, 32), jnp.bfloat16)
    value = jnp.asarray(rng.randn(2, s, 32), jnp.bfloat16)
    rest = dict(
        query_pos_input=rng.randn(2, 16, 6).astype(np.float32),
        key_padding_mask=np.concatenate(
            [np.asarray(m).reshape(2, -1) for m in masks], 1),
        reference_points=rng.rand(2, 16, 2).astype(np.float32),
        valid_ratios=np.array(jtr.get_valid_ratios(masks)))
    grad = rng.randn(2, 16, 32).astype(np.float32)
    jrest = {k: jnp.asarray(v) for k, v in rest.items()}
    jmodel = jtr.DeMFTransformerDecoderLayer(**cfg)
    jvars, sd = _carry(jmodel.init(jax.random.PRNGKey(0), query, value,
                                   spatial_shapes=SHAPES, **jrest),
                       'pts_bbox_head/decoder_0')

    def jfn(p, q, v):
        with jprec.compute_dtype_scope('bfloat16'):
            out = jmodel.apply(
                {'params': jprec.cast_floating(p, jnp.bfloat16),
                 'batch_stats': jvars['batch_stats']}, q, v,
                spatial_shapes=SHAPES, **jrest)
        return jnp.sum(out.astype(jnp.float32) * grad), out

    (_, jout), (jp, jq, jv) = jax.jit(jax.value_and_grad(
        jfn, (0, 1, 2), has_aux=True))(jvars['params'], query, value)
    head = 'pts_bbox_head.decoder.0.'
    want = {k[len(head):]: v.numpy() for k, v in state_dict_from_jax(
        {f'pts_bbox_head/decoder_0/{k}': np.asarray(v)
         for k, v in flatten_params(jp).items()}, {}).items()}
    want.update(query=np.asarray(jq, np.float32),
                value=np.asarray(jv, np.float32))

    def port(dtype):
        layer = transformer.DeMFTransformerDecoderLayer(**cfg)
        layer.load_state_dict(sd, strict=True)
        layer.eval()
        q, v = (torch.from_numpy(np.asarray(x, np.float32)).to(
            dtype or torch.float32).requires_grad_() for x in (query, value))
        t = {k: torch.from_numpy(v) for k, v in rest.items()}
        out = prec.policy_call(
            layer, dtype, q, v, t['query_pos_input'], t['key_padding_mask'],
            t['reference_points'], SHAPES, t['valid_ratios'])
        out.float().mul(torch.from_numpy(grad)).sum().backward()
        grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
        grads.update(query=q.grad.float().numpy(),
                     value=v.grad.float().numpy())
        return out, grads

    out, grads = port(torch.bfloat16)
    _, grads32 = port(None)
    assert out.dtype == torch.bfloat16
    assert _rel(out.detach().float(), np.asarray(jout, np.float32)) <= 2e-2
    assert set(grads) == set(want)
    closer = 0
    for name, w in want.items():
        assert grads[name].dtype == np.float32, name
        err, err32 = _rel(grads[name], w), _rel(grads32[name], w)
        assert err <= (0.25 if 'sampling_offsets' in name else 8e-2), (
            name, err)
        assert err <= 1.5 * err32, (name, err, err32)
        closer += err < err32
    assert closer >= 0.9 * len(want), (closer, len(want))


def test_bf16_step_batch_stats_match_jax_and_stay_float32(bf16_steps):
    jax_out, _, model, _, _ = bf16_steps
    want = state_dict_from_jax({}, jax_out['batch_stats'])
    got = model.state_dict()
    assert want
    for key, w in want.items():
        if key.endswith(('running_mean', 'running_var')):
            assert got[key].dtype == torch.float32, key
            assert _rel(got[key], w) < 3e-2, key


def test_bf16_step_keeps_float32_masters_and_optimizer_state(bf16_steps):
    _, _, model, optimizer, _ = bf16_steps
    assert all(p.dtype == torch.float32 for p in model.parameters())
    states = [s for s in optimizer.state.values() if s]
    assert states
    for s in states:
        for v in s.values():
            if torch.is_tensor(v) and v.is_floating_point():
                assert v.dtype == torch.float32


def test_bf16_step_losses_are_near_the_float32_step(bf16_steps):
    _, metrics, _, _, (metrics32, _) = bf16_steps
    for key, w in metrics32.items():
        if key != 'grad_norm':
            assert _rel(metrics[key], w) < 0.2, key
