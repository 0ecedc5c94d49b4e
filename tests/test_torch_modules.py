"""The port's modules against the JAX package's, with the same weights.

Each JAX module is initialized, its BatchNorm statistics and parameters are
perturbed in numpy (so a transposed or swapped weight cannot hide), and the
weights are carried into the port by ``engine.weights.state_dict_from_jax``
with a strict ``load_state_dict``.  Outputs agree to 1e-4 relative (fp32).
MSDA runs in fp32 on the JAX side (``DEMF_TPU_MSDA_F32=1``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.models import image_neck as jneck
from demf_tpu.models import pointnet2 as jpn
from demf_tpu.models import resnet as jresnet
from demf_tpu.models import transformer as jtr
from demf_tpu.ops.grouping import ball_query as jball_query
from demf_tpu.ops.sampling import furthest_point_sample as jfps
from demf_tpu.zoo import tiny_demf_model_cfg
from demf_tpu_torch.engine.weights import state_dict_from_jax
from demf_tpu_torch.models import image_neck, pointnet2, resnet, transformer

TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _carry(variables, prefix, seed=0):
    """Perturb the JAX variables; return them and the port's state_dict
    (keys relative to ``prefix``)."""
    rng = np.random.RandomState(seed)
    params = {k: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) *
              0.02 for k, v in flatten_params(variables['params']).items()}
    stats = {}
    for k, v in flatten_params(variables.get('batch_stats', {})).items():
        stats[k] = (rng.randn(*v.shape) * 0.1 if k.endswith('mean') else
                    rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
    jvars = {'params': unflatten_params(params)}
    if stats:
        jvars['batch_stats'] = unflatten_params(stats)
    sd = state_dict_from_jax({f'{prefix}/{k}': v for k, v in params.items()},
                             {f'{prefix}/{k}': v for k, v in stats.items()})
    head = prefix.replace('/', '.') + '.'
    return jvars, {k[len(head):]: v for k, v in sd.items()}


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_pointnet2_sassg(monkeypatch):
    cfg = dict(tiny_demf_model_cfg()['pts_backbone'])
    cfg.pop('type')
    cfg['sa_cfg'] = dict(cfg['sa_cfg'], ball_query_exact=True)
    points = np.random.RandomState(1).rand(2, 256, 4).astype(np.float32) * 2
    jmodel = jpn.PointNet2SASSG(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(points))
    jvars, sd = _carry(variables, 'pts_backbone')
    want = jmodel.apply(jvars, jnp.asarray(points), False)

    # the index ops have their own oracles: share the JAX side's picks
    def fps(xyz, k):
        return torch.from_numpy(np.asarray(
            jfps(jnp.asarray(xyz.numpy()), k)).astype(np.int64))

    def bq(radius, k, pts, centers):
        return torch.from_numpy(np.asarray(jball_query(
            radius, k, jnp.asarray(pts.numpy()), jnp.asarray(centers.numpy()),
            exact=True)).astype(np.int64))

    monkeypatch.setattr(pointnet2, 'furthest_point_sample', fps)
    monkeypatch.setattr(pointnet2, 'ball_query', bq)
    port = _load(pointnet2.PointNet2SASSG(**cfg), sd)
    with torch.no_grad():
        got = port(torch.from_numpy(points))
    for key in ('fp_xyz', 'fp_features'):
        assert _rel(got[key][-1], want[key][-1]) < TOL, key
    np.testing.assert_array_equal(got['fp_indices'][-1],
                                  want['fp_indices'][-1])


def test_resnet50():
    img = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    kw = dict(depth=50, out_indices=(1, 2, 3), frozen_stages=1)
    jmodel = jresnet.ResNet(**kw)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    jvars, sd = _carry(variables, 'img_backbone')
    want = jmodel.apply(jvars, jnp.asarray(img))
    port = _load(resnet.ResNet(**kw), sd)
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


def test_resnet50_norm_eval_false_takes_batch_statistics():
    """Without ``norm_eval`` a model in train mode normalizes with the
    batch's statistics and updates the running ones by flax's rule (biased
    variance, momentum 0.9): outputs 1e-4, running statistics 1e-5."""
    img = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    # two stages: deeper, the float32 rounding of the batch statistics
    # compounds on the JAX side (the port in float64 is then as far from it
    # as in float32: 2e-4 after stage 3, 9e-4 after stage 4)
    kw = dict(depth=50, num_stages=2, out_indices=(0, 1), norm_eval=False)
    jmodel = jresnet.ResNet(**kw)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    jvars, sd = _carry(variables, 'img_backbone')
    want, mutated = jmodel.apply(jvars, jnp.asarray(img), train=True,
                                 mutable=['batch_stats'])
    port = _load(resnet.ResNet(**kw), sd).train()
    assert port.bn1.training and port.layer2[2].bn2.training
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL
    stats = state_dict_from_jax({}, {
        f'img_backbone/{k}': np.asarray(v)
        for k, v in flatten_params(mutated['batch_stats']).items()})
    after = port.state_dict()
    checked = 0
    for key, w in stats.items():
        if key.endswith(('running_mean', 'running_var')):
            name = key[len('img_backbone.'):]
            assert not torch.equal(after[name], sd[name]), name
            assert _rel(after[name], w) < 1e-5, name
            checked += 1
    assert checked == 2 * 24
    # with norm_eval (every config) train mode leaves the statistics alone
    pinned = _load(resnet.ResNet(**dict(kw, norm_eval=True)), sd).train()
    assert not pinned.bn1.training
    with torch.no_grad():
        pinned(torch.from_numpy(img))
    assert torch.equal(pinned.state_dict()['bn1.running_mean'],
                       sd['bn1.running_mean'])


@pytest.mark.parametrize('frozen_stages', [-1, 0, 1, 2])
def test_resnet50_frozen_stages(frozen_stages):
    """The stem and the stages up to ``frozen_stages`` have
    ``requires_grad=False``, get no gradient and keep no graph; the names
    are the JAX package's ``frozen_param_patterns`` in the port's
    spelling."""
    port = resnet.ResNet(depth=50, out_indices=(0, 1, 2, 3),
                         frozen_stages=frozen_stages)
    patterns = port.frozen_param_patterns()
    want = jresnet.ResNet(frozen_stages=frozen_stages).frozen_param_patterns()
    assert patterns == [p.replace('_', '.') for p in want]
    for name, p in port.named_parameters():
        assert p.requires_grad != name.startswith(tuple(patterns)), name
    img = torch.from_numpy(
        np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32))
    outs = port.train()(img)
    for stage, out in enumerate(outs):
        assert out.requires_grad == (stage + 1 > frozen_stages), stage
    sum(o.sum() for o in outs).backward()
    for name, p in port.named_parameters():
        assert (p.grad is None) == name.startswith(tuple(patterns)), name


def test_channel_mapper():
    rng = np.random.RandomState(3)
    feats = [rng.randn(2, 8 // s, 12 // s, c).astype(np.float32)
             for s, c in ((1, 16), (2, 32), (4, 64))]
    kw = dict(in_channels=[16, 32, 64], out_channels=32, kernel_size=1,
              num_outs=4, norm_cfg=dict(type='GN', num_groups=8))
    jmodel = jneck.ChannelMapper(**kw)
    jin = tuple(jnp.asarray(f) for f in feats)
    jvars, sd = _carry(jmodel.init(jax.random.PRNGKey(0), jin), 'img_neck')
    want = jmodel.apply(jvars, jin)
    port = _load(image_neck.ChannelMapper(**kw), sd)
    with torch.no_grad():
        got = port(tuple(torch.from_numpy(f) for f in feats))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))


def test_deformable_detr_encoder(monkeypatch):
    monkeypatch.setenv('DEMF_TPU_MSDA_F32', '1')
    cfg = dict(tiny_demf_model_cfg()['img_encoder'])
    cfg.pop('type')
    rng = np.random.RandomState(4)
    feats = tuple(rng.randn(2, h, w, 32).astype(np.float32)
                  for h, w in SHAPES)
    img_shape = np.array([[60, 88], [64, 72]], np.int32)
    jmodel = jtr.DeformableDetrEncoder(**cfg)
    jin = (tuple(jnp.asarray(f) for f in feats), jnp.asarray(img_shape))
    jvars, sd = _carry(jmodel.init(jax.random.PRNGKey(0), *jin),
                       'img_encoder')
    want = jmodel.apply(jvars, *jin)
    port = _load(transformer.DeformableDetrEncoder(**cfg), sd)
    with torch.no_grad():
        got = port(tuple(torch.from_numpy(f) for f in feats),
                   torch.from_numpy(img_shape))
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


def test_demf_decoder_layer(monkeypatch):
    monkeypatch.setenv('DEMF_TPU_MSDA_F32', '1')
    cfg = dict(tiny_demf_model_cfg()['pts_bbox_head']['decoder'])
    cfg.pop('type')
    rng = np.random.RandomState(5)
    s = sum(h * w for h, w in SHAPES)
    img_shape = np.array([[60, 88], [64, 72]], np.int32)
    masks = jtr.make_level_masks(jnp.asarray(img_shape), (64, 96), SHAPES)
    inputs = dict(
        query=rng.randn(2, 16, 32).astype(np.float32),
        value=rng.randn(2, s, 32).astype(np.float32),
        query_pos_input=rng.randn(2, 16, 6).astype(np.float32),
        key_padding_mask=np.concatenate(
            [np.asarray(m).reshape(2, -1) for m in masks], 1),
        reference_points=rng.rand(2, 16, 2).astype(np.float32),
        valid_ratios=np.array(jtr.get_valid_ratios(masks)))
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jmodel = jtr.DeMFTransformerDecoderLayer(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jin.pop('query'),
                            jin.pop('value'), spatial_shapes=SHAPES, **jin)
    jvars, sd = _carry(variables, 'pts_bbox_head/decoder_0')
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = jmodel.apply(jvars, jin.pop('query'), jin.pop('value'),
                        spatial_shapes=SHAPES, **jin)
    port = _load(transformer.DeMFTransformerDecoderLayer(**cfg), sd)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        got = port(t['query'], t['value'], t['query_pos_input'],
                   t['key_padding_mask'], t['reference_points'], SHAPES,
                   t['valid_ratios'])
    assert _rel(got, want) < TOL


@pytest.mark.parametrize('level', range(len(SHAPES)))
def test_level_masks_and_valid_ratios(level):
    img_shape = np.array([[60, 88], [64, 72]], np.int32)
    want = jtr.make_level_masks(jnp.asarray(img_shape), (64, 96), SHAPES)
    got = transformer.make_level_masks(torch.from_numpy(img_shape), (64, 96),
                                       SHAPES)
    np.testing.assert_array_equal(got[level], want[level])
    assert _rel(transformer.get_valid_ratios(got),
                jtr.get_valid_ratios(want)) < 1e-7
