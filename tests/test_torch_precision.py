"""The port's bf16 mixed-precision policy against the JAX package's, on the
CPU (``demf_tpu_torch/utils/precision.py`` against
``demf_tpu/utils/precision.py``).

* the four decisions: which configs select the policy, which batch keys
  are cast, the scope that the point branch reads, the float32 islands;
* every geometric op (box rotation and corners, the inverse augmentation,
  the ``depth2img`` projection, the ball query's distances, FPS, the
  three-NN interpolation, the coders' decode, the vote-head targets) gives
  the same bits inside the policy as outside it: the policy casts weights
  and images, never coordinates, and uses no autocast;
* the MSDA plain version (K3 / K4's reference) on a bf16 value against the
  JAX op with a bf16 value (its bf16 gather planes, ``DEMF_TPU_MSDA_F32``
  unset): 2e-2 of the largest output and gradient, because the JAX op also
  rounds the bilinear corner weights and products to bf16 where the port
  keeps them float32;
* the tiny DeMF eval step (image branch included) under the policy against
  the JAX package's eval step under its policy: every stage prediction
  within 3e-2 of that tensor's largest; and against the port's own float32
  step within 0.2, the bound of ``tests/test_engine.py``.  bf16 keeps 8
  bits, so a product rounds by up to 2^-8 relative; the two frameworks
  round at different places (flax promotes inside its norms and
  attention, torch's CPU kernels accumulate bf16 products in float32), so
  the two runs differ by a few such steps after some twenty layers.
  That bound does not tell bf16 from float32 at this size (the port's
  float32 predictions lie within 2.7e-2 of JAX's bf16 ones), so the port's
  own bf16 - float32 gap is held to JAX's, tensor by tensor;
* ``policy_weights``: a copy made once for a frozen or served parameter,
  made again when an optimizer step or ``load_state_dict`` changes it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.engine.torch_port import unflatten_params
from demf_tpu.ops import msda as jmsda
from demf_tpu.utils import precision as jprec
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.core import boxes as box_ops
from demf_tpu_torch.core import coders, transforms
from demf_tpu_torch.engine import (batch_to_device, make_eval_step,
                                   state_dict_from_jax)
from demf_tpu_torch.models.target_assign import get_vote_head_targets
from demf_tpu_torch.ops import grouping, interpolate, msda, sampling
from demf_tpu_torch.utils import precision as prec
from test_torch_train_step import _jax_variables, tiny_batch, tiny_train_cfg

BF16 = torch.bfloat16


@pytest.mark.parametrize('cfg', [
    None, {}, {'bf16': True}, {'bf16': False}, {'fp16': {}},
    {'fp16': {'loss_scale': 512.0}}, {'fp16': None},
    {'bf16': True, 'fp16': {'loss_scale': 'dynamic'}}])
def test_resolve_compute_dtype_matches_jax(cfg):
    want = jprec.resolve_compute_dtype(cfg)
    assert want in (None, 'bfloat16')
    assert prec.resolve_compute_dtype(cfg) == (BF16 if want else None)


def test_cast_batch_casts_the_keys_jax_casts():
    """Only the network's image inputs; points, GT and calibration stay
    float32."""
    assert prec.CASTABLE_BATCH_KEYS == jprec._CASTABLE_BATCH_KEYS
    rng = np.random.RandomState(0)
    batch = dict(points=rng.rand(2, 8, 4).astype(np.float32),
                 img=rng.rand(2, 4, 6, 3).astype(np.float32),
                 img_features=(rng.rand(2, 2, 3, 4).astype(np.float32),
                               rng.rand(2, 1, 2, 4).astype(np.float32)),
                 img_meta=dict(depth2img=rng.rand(2, 4, 4).astype(
                     np.float32), img_shape=np.ones((2, 2), np.int32)),
                 gt_bboxes_3d=rng.rand(2, 3, 7).astype(np.float32),
                 gt_labels_3d=np.zeros((2, 3), np.int64),
                 gt_valid=np.ones((2, 3), bool))
    want = jprec.cast_batch(jax.tree_util.tree_map(jnp.asarray, batch),
                            jnp.bfloat16)
    got = prec.cast_batch(batch_to_device(batch, 'cpu'), BF16)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t, got,
                               is_leaf=lambda t: isinstance(t,
                                                            torch.Tensor)))
    assert len(flat_got) == len(flat_want) == 9
    for (path, w), (gpath, g) in zip(flat_want, flat_got):
        assert str(path) == str(gpath)
        if g.is_floating_point():
            assert str(w.dtype) == str(g.dtype).replace('torch.', ''), path
        else:   # integers and masks are never cast (JAX keeps int32)
            assert not jnp.issubdtype(w.dtype, jnp.inexact), path
    assert got['points'].dtype == torch.float32
    assert got['img'].dtype == BF16


def test_cast_compute_reads_the_scope():
    """As the JAX package's: nested scopes restore the outer one."""
    x = torch.ones(3)
    assert prec.cast_compute(x) is x
    with prec.compute_dtype_scope(BF16):
        assert prec.cast_compute(x).dtype == BF16
        with prec.compute_dtype_scope(None):
            assert prec.cast_compute(x) is x
        assert prec.cast_compute(x).dtype == BF16
    assert prec.cast_compute(x) is x


def test_cast_helpers_leave_a_float32_run_as_it_is():
    """A ``dtype`` of None (the policy off) passes batch and results
    through, so the steps call the helpers whatever the dtype."""
    batch = {'img': torch.ones(2), 'points': torch.ones(3)}
    tree = {'a': [torch.ones(2)], 'b': (torch.ones(1, dtype=BF16),)}
    assert prec.cast_batch(batch, None) is batch
    assert prec.cast_floating(tree, None) is tree


def test_policy_weights_keep_copies_until_the_weights_change():
    """A parameter that takes a gradient is cast on every call; any other
    copy (a frozen layer; every layer under inference_mode) is kept until
    an optimizer step or ``load_state_dict`` changes the parameter."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    model[0].requires_grad_(False)
    first = prec.policy_weights(model, BF16)
    again = prec.policy_weights(model, BF16)
    assert again['0.weight'] is first['0.weight']
    assert again['1.weight'] is not first['1.weight']
    assert again['1.weight'].requires_grad
    with torch.inference_mode():
        served = prec.policy_weights(model, BF16)
        assert prec.policy_weights(model, BF16)['1.weight'] is \
            served['1.weight']
    assert not served['1.weight'].is_inference()
    optimizer = torch.optim.SGD(model[1].parameters(), lr=0.1)
    out = prec.policy_call(model, BF16, torch.ones(1, 4, dtype=BF16))
    out.float().sum().backward()
    optimizer.step()
    with torch.inference_mode():
        stepped = prec.policy_weights(model, BF16)
    assert stepped['0.weight'] is first['0.weight']
    assert stepped['1.weight'] is not served['1.weight']
    assert torch.equal(stepped['1.weight'], model[1].weight.to(BF16))
    model.load_state_dict({k: v + 1 for k, v in model.state_dict().items()})
    loaded = prec.policy_weights(model, BF16)
    assert loaded['0.weight'] is not first['0.weight']
    assert torch.equal(loaded['0.weight'], model[0].weight.to(BF16))
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_policy_call_runs_on_bf16_copies_and_grads_reach_fp32_masters():
    lin = torch.nn.Linear(4, 3)
    bn = torch.nn.BatchNorm1d(3)
    model = torch.nn.ModuleDict(dict(lin=lin, bn=bn))

    def forward(x):
        from demf_tpu_torch.models.pointnet2 import bn_last
        y = prec.dense(prec.cast_compute(x), lin)
        assert y.dtype == BF16 and lin.weight.dtype == BF16
        return bn_last(bn, y)

    model.forward = forward
    model.train()
    x = torch.randn(5, 4)
    out = prec.policy_call(model, BF16, x)
    assert out.dtype == BF16
    prec.cast_floating(out, torch.float32).square().sum().backward()
    assert lin.weight.dtype == torch.float32
    assert lin.weight.grad.dtype == torch.float32
    assert bn.weight.grad.dtype == torch.float32
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    assert torch.any(bn.running_mean != 0)


# -- geometry: the same bits inside the policy as outside it ----------------

def _geometry_inputs():
    rng = np.random.RandomState(3)
    b, p, n = 2, 300, 24
    points = torch.from_numpy(rng.uniform(-4, 4, (b, p, 3)).astype(
        np.float32))
    boxes = np.concatenate([rng.uniform(-3, 3, (b, n, 3)),
                            rng.uniform(0.3, 2.0, (b, n, 3)),
                            rng.uniform(-np.pi, np.pi, (b, n, 1))], -1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    rot = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                              [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                    for a in rng.uniform(-0.5, 0.5, b)]).astype(np.float32)
    batch = zoo.synth_demf_batch(b, p=p, g=n, hw=(800, 1344), seed=3,
                                 valid_hw=(784, 1312))
    meta = batch_to_device(batch['img_meta'], 'cpu')
    meta['pcd_rotation'] = torch.from_numpy(rot)
    meta['pcd_scale_factor'] = torch.tensor([1.1, 0.93])
    meta['pcd_trans'] = torch.from_numpy(rng.randn(b, 3).astype(np.float32))
    meta['pcd_horizontal_flip'] = torch.tensor([True, False])
    meta['flip'] = torch.tensor([False, True])
    reg = torch.from_numpy(rng.randn(b, n, 3 + 12 * 2 + 10 * 4).astype(
        np.float32))
    cls = torch.from_numpy(rng.randn(b, n, 12).astype(np.float32))
    feats = torch.from_numpy(rng.randn(b, 40, 16).astype(np.float32))
    return dict(points=points, boxes=boxes, meta=meta, reg=reg, cls=cls,
                feats=feats, labels=torch.from_numpy(
                    rng.randint(0, 10, (b, n))),
                valid=torch.from_numpy(rng.rand(b, n) < 0.7))


def _geometry(x):
    """Every geometric op of the port's paths on float32 inputs."""
    points, boxes, meta = x['points'], x['boxes'], x['meta']
    out = dict(
        in_boxes=box_ops.points_in_boxes(points, boxes),
        corners=box_ops.box_corners(boxes.reshape(-1, 7)),
        rotated=box_ops.rotation_3d_in_axis(points, boxes[:, 0, 6]),
        reversed=transforms.reverse_3d_transform(points, meta),
        projected=transforms.project_points_to_image(points, meta),
        sqdist=grouping.sqdist(points, points[:, :50]),
        ball=grouping.ball_query_plain(0.8, 8, points, points[:, :50]),
        fps=sampling.furthest_point_sample_plain(points, 40),
        interpolated=interpolate.three_nn_interpolate(
            points, points[:, :40], x['feats']))
    ca = coders.ClassAgnosticBBoxCoder(num_dir_bins=12)
    res = ca.split_pred(x['cls'].transpose(1, 2),
                        x['reg'][..., :30].transpose(1, 2), boxes[..., :3])
    out['ca_decode'] = ca.decode(res)
    demf = coders.DeMFClassAgnosticBBoxCoder(num_dir_bins=12)
    res = demf.split_pred(x['cls'].transpose(1, 2),
                          x['reg'][..., :30].transpose(1, 2), boxes[..., :3])
    out['demf_decode'] = demf.decode(res)
    pb = coders.PartialBinBasedBBoxCoder(12, 10, np.random.RandomState(
        0).uniform(0.3, 2, (10, 3)))
    res = pb.split_pred(x['cls'].transpose(1, 2), x['reg'].transpose(1, 2),
                        boxes[..., :3])
    out['pb_decode'] = pb.decode(res)
    out['pb_encode'] = pb.encode(boxes, x['labels'])
    targets = get_vote_head_targets(
        points, boxes, x['labels'], x['valid'], boxes[..., :3] + 0.1, demf,
        dict(pos_distance_thr=1.5, neg_distance_thr=2.5), 3, mode='demf')
    out.update({f'target_{k}': v for k, v in targets.items()})
    return out


def _flat(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


def test_geometry_is_bit_equal_inside_and_outside_the_policy():
    """Run once plainly, once inside the policy's scope, and once as the
    forward of a model that ``policy_call`` runs on bf16 weights: every
    output has the same dtype and bits (float32 in, float32 out)."""
    x = _geometry_inputs()
    plain = _geometry(x)
    with prec.compute_dtype_scope(BF16):
        scoped = _geometry(x)
    model = torch.nn.Linear(3, 3)

    def forward(inputs):
        assert model.weight.dtype == BF16      # the weights are the copies
        return _geometry(inputs)

    model.forward = forward
    under_policy = prec.policy_call(model, BF16, x)
    assert len(_flat(plain)) > 25
    for other in (scoped, under_policy):
        for a, b in zip(_flat(plain), _flat(other)):
            assert a.dtype == b.dtype and a.dtype != BF16
            assert torch.equal(a, b)


# -- MSDA on a bf16 value: the plain version against the JAX op -------------

@pytest.mark.parametrize('q', [24, None])
def test_msda_plain_on_bf16_value_matches_jax(q, monkeypatch):
    """A decoder's few queries (the JAX op's small-Q route) and one query a
    token (its quad-plane route), forward and all three gradients."""
    monkeypatch.delenv('DEMF_TPU_MSDA_F32', raising=False)
    shapes = ((8, 12), (4, 6), (2, 3))
    s = sum(h * w for h, w in shapes)
    q = q or s
    rng = np.random.RandomState(q)
    value = rng.randn(2, s, 2, 16).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (2, q, 2, 3, 2, 2)).astype(np.float32)
    aw = rng.rand(2, q, 2, 3, 2).astype(np.float32)
    grad = rng.randn(2, q, 32).astype(np.float32)
    jvalue = jnp.asarray(value, jnp.bfloat16)

    def jfn(v, lc, a):
        out = jmsda.multi_scale_deformable_attention(v, shapes, lc, a)
        return jnp.sum(out.astype(jnp.float32) * grad), out

    (_, jout), jgrads = jax.value_and_grad(jfn, (0, 1, 2), has_aux=True)(
        jvalue, jnp.asarray(locs), jnp.asarray(aw))
    assert jout.dtype == jnp.bfloat16
    ins = [torch.from_numpy(value).to(BF16).requires_grad_(),
           torch.from_numpy(locs).requires_grad_(),
           torch.from_numpy(aw).requires_grad_()]
    out = msda.multi_scale_deformable_attention(ins[0], shapes, ins[1],
                                                ins[2])
    assert out.dtype == BF16
    out.float().mul(torch.from_numpy(grad)).sum().backward()
    pairs = [(out, jout)] + [(t.grad, g) for t, g in zip(ins, jgrads)]
    assert [t.grad.dtype for t in ins] == [BF16, torch.float32,
                                           torch.float32]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max()


# -- the tiny DeMF eval step under the policy, port against JAX -------------

@pytest.fixture(scope='module')
def eval_runs():
    """Stage predictions of the tiny DeMF (image branch included) in eval
    mode, from the same weights and batch: JAX under its policy, the port
    under its policy and in float32."""
    cfg = tiny_train_cfg()
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = tiny_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = _jax_variables(jmodel, jbatch)

    @jax.jit
    def jax_eval(p, s, b):
        with jprec.compute_dtype_scope('bfloat16'):
            res = jmodel.apply(
                {'params': jprec.cast_floating(p, jnp.bfloat16),
                 'batch_stats': s}, jprec.cast_batch(b, jnp.bfloat16),
                train=False)
        return jprec.cast_floating(res, 'float32')

    want = jax.device_get(jax_eval(unflatten_params(params),
                                   unflatten_params(stats), jbatch))
    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    tbatch = batch_to_device(batch, 'cpu')
    with torch.inference_mode():
        bf16 = prec.cast_floating(prec.policy_call(
            model, BF16, prec.cast_batch(tbatch, BF16)), torch.float32)
        fp32 = model(tbatch)
    det = make_eval_step(model, BF16)(tbatch)
    return want, bf16, fp32, det, model


STAGE_KEYS = ('center', 'size', 'dir_class', 'dir_res_norm', 'obj_scores',
              'sem_scores')


def _stages_within(got, want, bound):
    compared = 0
    for g_stage, w_stage in zip(got['decode_res_all'],
                                want['decode_res_all']):
        for key in STAGE_KEYS:
            g = np.asarray(g_stage[key].float())
            w = np.asarray(w_stage[key], np.float32)
            assert g.shape == w.shape and g.dtype == np.float32
            err = np.abs(g - w).max()
            assert err <= bound * np.abs(w).max(), (key, err)
            compared += 1
    return compared


def test_eval_step_under_the_policy_matches_jax(eval_runs):
    want, bf16, _, _, _ = eval_runs
    assert _stages_within(bf16, want, 3e-2) == 2 * len(STAGE_KEYS)
    for key in ('seed_points', 'seed_indices'):   # coordinates: exact
        np.testing.assert_array_equal(np.asarray(bf16[key]),
                                      np.asarray(want[key]))


def test_eval_step_under_the_policy_is_near_float32(eval_runs):
    _, bf16, fp32, _, _ = eval_runs
    assert _stages_within(bf16, fp32, 0.2) == 2 * len(STAGE_KEYS)


def _stage_gaps(got, want):
    """Max error over each stage prediction's largest, as an array."""
    def f32(x):
        return x.float().numpy() if torch.is_tensor(x) else np.asarray(
            x, np.float32)
    return np.array([
        np.abs(f32(g[key]) - f32(w[key])).max() / np.abs(f32(w[key])).max()
        for g, w in zip(got['decode_res_all'], want['decode_res_all'])
        for key in STAGE_KEYS])


def test_eval_step_under_the_policy_rounds_as_much_as_jax(eval_runs):
    """The 3e-2 bound against JAX does not tell the port's bf16 run from
    its float32 run: the port's float32 predictions lie within 2.7e-2 of
    JAX's bf16 ones too.  What does: the port's own bf16 - float32 gap,
    tensor by tensor, against JAX's bf16 - float32 gap (measured from the
    port's float32 run, which equals JAX's float32 run to 1e-4,
    ``tests/test_torch_slice.py``) lie between half and twice each other
    (seen: 0.66 to 1.12 times, the gaps 4e-4 to 2.7e-2).  A float32 run
    has no gap; a policy that rounded coordinates or losses would have a
    far larger one."""
    want, bf16, fp32, _, _ = eval_runs
    ratio = _stage_gaps(bf16, fp32) / _stage_gaps(want, fp32)
    assert np.all((ratio >= 0.5) & (ratio <= 2)), ratio


def test_eval_step_under_the_policy_gives_float32_detections(eval_runs):
    _, _, _, det, model = eval_runs
    assert det['boxes_3d'].dtype == torch.float32
    assert torch.isfinite(det['boxes_3d']).all()
    assert torch.isfinite(det['scores_3d']).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
