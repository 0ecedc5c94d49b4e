"""FCAF3D's train step at the tiny config's own 10 cm voxels against the
JAX package's, in float64 on both sides, on the CPU.

At 10 cm the coarsest levels of ``configs/synthetic/fcaf3d_tiny.py`` hold
1-2 voxels a scene, and a train-mode BatchNorm over so few rows leaves
gradients that float32 does not resolve: against the float64 step below,
the JAX package's own float32 step strays by up to 1.0e-3, 0.17 and
5.5e-4 of a tensor's largest at seeds 0, 1 and 2, the port's by 2.0e-3,
1.02 and 5.7e-3, and by 1.8e-3, 0.054 and 4.4e-3 with its taps summed in
reverse order (``PYTHONPATH=. python
tests/test_torch_fcaf3d_train_coarse.py [seeds]`` prints these), where
``test_torch_fcaf3d_train.py`` holds its float32 steps at 3 cm to 1e-3.
``... --layers [seeds]`` shows why: fed JAX's float32 output of every
``MaskedBatchNorm``, the port's float32 layers, forward and backward,
stray from float64 as far as JAX's own; unfed, they first stray further
at layer 4, whose norms count 1-2 voxels a scene and amplify rounding that
both packages make alike in size but not in bits.
So the two packages meet here where rounding is no excuse: the port's
model and scenes in float64 (its ``MaskedBatchNorm`` computes in the rows'
dtype)
against ``jax.value_and_grad`` under ``jax.enable_x64`` with float64
weights and scenes, the JAX ``MaskedBatchNorm``'s statistics taken in the
rows' dtype (``Float64Stats``, a subclass made here: the package takes
them in float32).  The losses within 1e-6 relative, each gradient within
1e-5 of its tensor's largest, the BatchNorm running statistics within
1e-10 relative: what float32 casts that both packages keep (the voxels'
points, the JAX package's ``_conv_dweights`` sums) leave.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
import demf_tpu.models.fcaf3d as jax_fcaf3d
import demf_tpu.models.mink_resnet as jax_mink
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import batch_to_device
from demf_tpu_torch.engine.weights import state_dict_from_jax
from test_torch_fcaf3d import jax_variables
from test_torch_fcaf3d_train import rel, train_batch


class Float64Stats(jax_mink.MaskedBatchNorm):
    """The JAX package's ``MaskedBatchNorm`` with the statistics in the
    rows' dtype (the package takes them in float32)."""

    @nn.compact
    def __call__(self, x, valid, train: bool = False):
        c = x.shape[-1]
        ra_mean = self.variable('batch_stats', 'mean',
                                lambda: jnp.zeros((c,)))
        ra_var = self.variable('batch_stats', 'var',
                               lambda: jnp.ones((c,)))
        scale = self.param('scale', nn.initializers.ones, (c,))
        bias = self.param('bias', nn.initializers.zeros, (c,))
        if train:
            w = valid[..., None].astype(x.dtype)
            cnt = jnp.maximum(w.sum((0, 1)), 1.0)
            mean = (x * w).sum((0, 1)) / cnt
            var = (jnp.square(x - mean) * w).sum((0, 1)) / cnt
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        else:
            mean, var = ra_mean.value, ra_var.value
        y = (x - mean) * jax.lax.rsqrt(var + self.epsilon) * scale + bias
        return y.astype(x.dtype)


def in_dtype(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype.kind == 'f'
        else jnp.asarray(a), tree)


def jax_step(jmodel, params, stats, batch, dtype):
    """(losses, flat grads, flat new batch stats) of one JAX train step's
    loss with weights and scenes in ``dtype`` (float64: under
    ``jax.enable_x64``, the statistics by ``Float64Stats``)."""
    def loss_fn(p, s, b):
        results, mutated = jmodel.apply(
            {'params': p, 'batch_stats': s}, b, train=True,
            mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(2),
                                           'sample': jax.random.PRNGKey(1)})
        losses = jmodel.loss(results, b)
        return sum(losses.values()), (losses, mutated['batch_stats'])

    def run():
        args = (in_dtype(unflatten_params(params), dtype),
                in_dtype(unflatten_params(stats), dtype),
                in_dtype(batch, dtype))
        (_, (losses, new_bs)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(*args))
        return losses, flatten_params(grads), flatten_params(new_bs)

    if dtype == jnp.float32:
        return run()
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mink, 'MaskedBatchNorm', Float64Stats)
        mp.setattr(jax_fcaf3d, 'MaskedBatchNorm', Float64Stats)
        return run()


def port_step(cfg, params, stats, batch, dtype):
    """The port's model in ``dtype`` after one forward, loss and backward
    in train mode from the same weights (no update), and its losses."""
    model = zoo.build_detector(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model = model.to(dtype).train()
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in batch_to_device(batch, 'cpu').items()}
    losses = model.loss(model(tb, generator=torch.Generator().manual_seed(0)),
                        tb)
    sum(losses.values()).backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}


def coarse_case(seed):
    cfg = dict(zoo.load_model_cfg('synthetic/fcaf3d_tiny.py').model)
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = train_batch(zoo.synth_fcaf3d_batch, b=2, p=1024, g=4, seed=seed)
    params, stats = jax_variables(
        jmodel, jax.tree_util.tree_map(jnp.asarray, batch), seed=seed)
    return cfg, jmodel, batch, params, stats


@pytest.fixture(scope='module')
def float64_pair():
    """(JAX's float64 step, the port's float64 model after its backward,
    its losses), at 10 cm."""
    cfg, jmodel, batch, params, stats = coarse_case(0)
    assert cfg['voxel_size'] == 0.1
    jax_out = jax_step(jmodel, params, stats, batch, jnp.float64)
    model, losses = port_step(cfg, params, stats, batch, torch.float64)
    return jax_out, model, losses


def test_float64_step_losses_match_jax_at_10cm(float64_pair):
    (want, _, _), _, got = float64_pair
    assert set(got) == set(want)
    for key, w in want.items():
        assert float(w) > 0, key              # every term is exercised
        assert rel(got[key], w) < 1e-6, key


def test_float64_step_grads_match_jax_at_10cm(float64_pair):
    (_, grads, _), model, _ = float64_pair
    want = state_dict_from_jax(grads, {})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        w = want[name].numpy()
        assert w.dtype == np.float64 and np.abs(w).max() > 0, name
        assert rel(p.grad, w) <= 1e-5, name


def test_float64_step_batch_stats_match_jax_at_10cm(float64_pair):
    (_, grads, new_bs), model, _ = float64_pair
    want = state_dict_from_jax(grads, new_bs)
    got = model.state_dict()
    keys = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert len(keys) > 40
    for key in keys:
        assert rel(got[key], want[key]) < 1e-10, key


def float32_gaps(seed):
    """Each package's float32 gradients against JAX's float64 ones at 10 cm
    (of each tensor's largest): {name: (JAX's, the port's, the port's with
    its convolutions summing their taps in reverse order)}."""
    from demf_tpu_torch.ops import sparse
    cfg, jmodel, batch, params, stats = coarse_case(seed)
    _, ref, _ = jax_step(jmodel, params, stats, batch, jnp.float64)
    _, j32, _ = jax_step(jmodel, params, stats, batch, jnp.float32)
    model, _ = port_step(cfg, params, stats, batch, torch.float32)
    plain = sparse.sparse_conv_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sparse, 'sparse_conv_plain', lambda f, n, w: plain(
            f, n.flip(-1), w.flip(0)))
        reordered, _ = port_step(cfg, params, stats, batch, torch.float32)
    ref = state_dict_from_jax(ref, {})
    j32 = state_dict_from_jax(j32, {})
    other = dict(reordered.named_parameters())
    return {n: (rel(j32[n], ref[n]), rel(p.grad, ref[n]),
                rel(other[n].grad, ref[n]))
            for n, p in model.named_parameters()}


def _norm_module(path):
    """The port's ``MaskedBatchNorm`` module name of a JAX norm's path."""
    from demf_tpu_torch.engine.weights import _mink_entry
    key, _ = _mink_entry(f'{path}/scale', np.zeros(1))
    return key[:-len('.bn.weight')]


def jax_norm_outputs(jmodel, params, stats, batch, dtype):
    """{the port's module name: the output of that ``MaskedBatchNorm``} of
    one JAX train-mode forward in ``dtype`` (flax's
    ``capture_intermediates``), in the order they ran."""
    def run():
        _, mutated = jax.jit(lambda p, s, b: jmodel.apply(
            {'params': p, 'batch_stats': s}, b, train=True,
            mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda m, _: isinstance(
                m, jax_mink.MaskedBatchNorm)))(
            in_dtype(unflatten_params(params), dtype),
            in_dtype(unflatten_params(stats), dtype),
            in_dtype(batch, dtype))
        flat = flatten_params(jax.device_get(mutated['intermediates']))
        return {_norm_module(k[:-len('/__call__')]): np.asarray(v[0])
                for k, v in flat.items()}

    if dtype == jnp.float32:
        return run()
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mink, 'MaskedBatchNorm', Float64Stats)
        mp.setattr(jax_fcaf3d, 'MaskedBatchNorm', Float64Stats)
        return run()


def port_norm_outputs(cfg, params, stats, batch, dtype, feed=None):
    """({module name: output} of every ``MaskedBatchNorm`` in the port's
    train-mode forward in ``dtype``, in the order they ran, {parameter
    name: gradient} of that step's loss).  With ``feed`` ({module name:
    array}) each norm's output takes that array's values (cast to
    ``dtype``) before the next layer reads it, its gradient still flowing
    through the norm, so a layer's own rounding shows apart from what
    reaches it."""
    from demf_tpu_torch.models.mink_resnet import MaskedBatchNorm
    model = zoo.build_detector(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model = model.to(dtype).train()
    out = {}

    def hook(name):
        def record(module, args, y):
            out[name] = y.detach().numpy().copy()
            if feed is not None and name in feed:
                want = torch.as_tensor(np.array(feed[name]), dtype=y.dtype)
                return y + (want - y).detach()
        return record

    for name, m in model.named_modules():
        if isinstance(m, MaskedBatchNorm):
            m.register_forward_hook(hook(name))
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in batch_to_device(batch, 'cpu').items()}
    losses = model.loss(model(tb, generator=torch.Generator().manual_seed(0)),
                        tb)
    sum(losses.values()).backward()
    return out, {n: p.grad for n, p in model.named_parameters()}


def layer_gaps(seed):
    """Each ``MaskedBatchNorm``'s output in float32 against float64 (of
    its float64 output's largest), in the order the forward runs it: the
    JAX package's, the port's, and the port's own layer fed JAX's float32
    output of every earlier norm (what the layer itself adds); then each
    parameter's float32 gradient against JAX's float64 one, in the order
    the backward reaches it: JAX's, the port's, and the port's on the fed
    activations (what its backward itself adds)."""
    cfg, jmodel, batch, params, stats = coarse_case(seed)
    j64 = jax_norm_outputs(jmodel, params, stats, batch, jnp.float64)
    j32 = jax_norm_outputs(jmodel, params, stats, batch, jnp.float32)
    p32, g32 = port_norm_outputs(cfg, params, stats, batch, torch.float32)
    fed, gfed = port_norm_outputs(cfg, params, stats, batch, torch.float32,
                                  feed=j32)
    norms = [(name, rel(j32[name], j64[name]), rel(p32[name], j64[name]),
              rel(fed[name], j64[name])) for name in p32]
    _, ref, _ = jax_step(jmodel, params, stats, batch, jnp.float64)
    _, jg32, _ = jax_step(jmodel, params, stats, batch, jnp.float32)
    ref = state_dict_from_jax(ref, {})
    jg32 = state_dict_from_jax(jg32, {})
    grads = [(n, rel(jg32[n], ref[n]), rel(g32[n], ref[n]),
              rel(gfed[n], ref[n])) for n in reversed(list(g32))]
    return norms, grads


if __name__ == '__main__':
    if sys.argv[1:2] == ['--layers']:
        for seed in map(int, sys.argv[2:] or (0, 1, 2)):
            norms, grads = layer_gaps(seed)
            for what, rows in (('norm\'s float32 output', norms),
                               ('float32 gradient, backward order,', grads)):
                print(f'seed {seed}: each {what} against float64 at 10 cm '
                      f'(of its largest): JAX / the port / the port fed '
                      f'JAX\'s float32 norm outputs')
                for name, j, p, f in rows:
                    print(f'  {name:44s} {j:.3e} {p:.3e} {f:.3e}'
                          + ('  <- the port further' if p > 2 * max(j, 1e-7)
                             else '')
                          + ('  <- fed, still further' if f > 2 * max(j, 1e-7)
                             else ''))
        sys.exit(0)
    for seed in map(int, sys.argv[1:] or (0, 1, 2)):
        gaps = float32_gaps(seed)
        largest = [max(g[i] for g in gaps.values()) for i in range(3)]
        past = [sum(g[i] > 1e-3 for g in gaps.values()) for i in range(3)]
        print(f'seed {seed}: float32 against JAX in float64 at 10 cm, the '
              f'largest of each tensor\'s largest (tensors past 1e-3 of '
              f'{len(gaps)}): JAX {largest[0]:.3e} ({past[0]}), the port '
              f'{largest[1]:.3e} ({past[1]}), the port with its taps summed '
              f'in reverse {largest[2]:.3e} ({past[2]})', flush=True)
