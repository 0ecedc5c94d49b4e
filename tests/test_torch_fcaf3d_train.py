"""FCAF3D trained by the port (``models/fcaf3d.py``'s targets and loss,
``models/mink_resnet.py`` in train mode, the sparse convolutions' backward
of ``ops/sparse.py``) against the JAX package's, on the CPU.

* one train step of ``configs/synthetic/fcaf3d_tiny.py`` (MinkResNet18 at
  stem 16, a 32-wide head) on the same weights and scenes: the JAX side's
  ``jax.value_and_grad`` of ``model.apply(train=True)`` + ``model.loss``,
  the port's ``zoo.build_trainer`` step.  Losses and the gradient norm
  within 1e-4 relative, each gradient within 1e-3 of its tensor's largest,
  the BatchNorm running statistics within 1e-5 relative (the bounds of
  ``tests/test_torch_train_step.py``).  The step runs the config at 3 cm
  voxels (``tiny_train_cfg``), where the levels hold 8-128 rows a scene: at
  its own 10 cm the coarsest hold 1-2, and a train-mode BatchNorm over so
  few rows leaves gradients that float32 does not resolve to that bound,
  the JAX package's (1.0e-3 of a tensor's largest from float64 at this
  seed, 0.17 at seed 1) nor the port's (2.0e-3, 1.02);
  ``test_torch_fcaf3d_train_coarse.py`` holds the two packages to each
  other at 10 cm in float64 instead.  The GT boxes are twice the size and
  moved 1.5 m towards the voxels the capacity keeps (the lowest keys), so
  that every loss term has positives;
* the same step under the bf16 policy (the port's ``bf16=True``, the JAX
  side ``make_train_step``'s loss under ``compute_dtype='bfloat16'``).
  The JAX package rounds where the port does not: its
  ``_conv_scan_math`` sums each tap into a bf16 accumulator in the forward
  and in d_feats, K14 and its plain version sum in float32 and round once
  (d_weights is a float32 sum rounded to bf16 in both).  So the port is
  held to the JAX package's own bf16 - float32 gap, not to its bits:
  every loss within 4 times JAX's largest loss gap of JAX's bf16 loss
  (seen 1.9), the BatchNorm statistics within twice JAX's largest
  statistics gap (seen 1.01), and the gradients of the backbone and of
  the head, each part as one vector, within 1.5 times JAX's gap of that
  part (seen 0.83 and 0.87), the port's own bf16 - float32 gap within a
  third and three times JAX's (seen 0.92 and 0.75).  No gradient is
  compared tensor by tensor: bf16 leaves the backbone's chaotic in both
  packages (each tensor's bf16 - float32 gap 10-85% of its largest in
  JAX, up to 6% in the head), and float32 itself misses float64 on part
  of them (the ``grad_norm``, which the clip reads, is not compared
  either: it moves with them).  Master weights, gradients and statistics
  stay float32;
* ``MaskedBatchNorm``'s train branch against the JAX package's (valid rows
  only, biased variance, momentum 0.9);
* ``get_targets`` against the JAX package's: labels and the chosen box
  exactly, the centerness within 1e-6;
* the rotated IoU's gradient against ``jax.grad``, finite on the loss's
  dummy rows and on boxes with parallel edges.

A checkpoint the train entry writes, ported back by the JAX package's
``port_fcaf3d_checkpoint``, is held to JAX's eval forward in
``tests/test_torch_fcaf3d.py``, whose JAX compile it shares.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.utils import precision as jprec
from demf_tpu.core.rotated_iou import iou3d_aligned as jax_iou3d_aligned
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.models.mink_resnet import MaskedBatchNorm as JaxBatchNorm
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.core.rotated_iou import iou3d_aligned
from demf_tpu_torch.engine import batch_to_device
from demf_tpu_torch.engine.weights import state_dict_from_jax
from demf_tpu_torch.models.fcaf3d import DUMMY_BBOX_PRED, FCAF3DHead
from demf_tpu_torch.models.mink_resnet import MaskedBatchNorm
from test_torch_fcaf3d import jax_variables


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


TRAIN_VOXEL = 0.03


def tiny_train_cfg(rel_path):
    """The model of a tiny config at ``TRAIN_VOXEL`` voxels (the module
    docstring says why)."""
    full = zoo.load_model_cfg(rel_path)
    cfg = dict(full.model, voxel_size=TRAIN_VOXEL)
    cfg['head'] = dict(cfg['head'], voxel_size=TRAIN_VOXEL)
    return full, cfg


def train_batch(maker, **kw):
    """A synthetic batch whose GT boxes are twice the size and 1.5 m
    further down the x axis, where the voxels the capacity keeps lie."""
    batch = maker(**kw)
    batch['gt_bboxes_3d'][..., 3:6] *= 2
    batch['gt_bboxes_3d'][..., 0] -= 1.5
    return batch


def jax_train_step(jmodel, params, stats, jbatch, compute_dtype=None):
    """(total, losses, flat grads, flat new batch stats, grad norm) of one
    JAX train step's loss; under ``compute_dtype`` the policy of
    ``demf_tpu/engine/trainer.py::make_train_step``'s loss (bf16 copies of
    the parameters and of the batch's network inputs, the policy's scope,
    the results back in float32 before the loss)."""
    import optax

    def loss_fn(p):
        net_batch = jbatch
        if compute_dtype is not None:
            p = jprec.cast_floating(p, compute_dtype)
            net_batch = jprec.cast_batch(jbatch, compute_dtype)
        with jprec.compute_dtype_scope(compute_dtype):
            results, mutated = jmodel.apply(
                {'params': p, 'batch_stats': stats}, net_batch, train=True,
                mutable=['batch_stats'],
                rngs={'dropout': jax.random.PRNGKey(2),
                      'sample': jax.random.PRNGKey(1)})
        if compute_dtype is not None:
            results = jprec.cast_floating(results, 'float32')
        losses = jmodel.loss(results, jbatch)
        return sum(losses.values()), (losses, mutated['batch_stats'])

    (total, (losses, new_bs)), grads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params))
    return dict(total=total, losses=losses, grads=flatten_params(grads),
                batch_stats=flatten_params(new_bs),
                grad_norm=float(optax.global_norm(grads)))


def port_train_step(cfg, full, params, stats, batch, bf16=False):
    """The port's model after one ``zoo.build_trainer`` step from the same
    weights (under the bf16 policy with ``bf16``), and the step's
    metrics."""
    run = dict(model=cfg, optimizer=full.optimizer,
               optimizer_config=full.optimizer_config,
               lr_config=full.lr_config)
    if bf16:
        run['bf16'] = True
    model, _, step = zoo.build_trainer(run, 'cpu')
    assert step.compute_dtype == (torch.bfloat16 if bf16 else None)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    metrics = step(batch_to_device(batch, 'cpu'),
                   torch.Generator().manual_seed(0))
    return model, metrics


def check_losses(jax_out, metrics):
    want = jax_out['losses']
    assert set(metrics) == set(want) | {'loss', 'grad_norm'}
    for key, w in want.items():
        assert float(w) > 0, key              # every term is exercised
        assert np.isfinite(float(metrics[key]))
        assert rel(metrics[key], w) < 1e-4, key
    assert rel(metrics['loss'], jax_out['total']) < 1e-4
    assert rel(metrics['grad_norm'], jax_out['grad_norm']) < 1e-4


def check_grads(jax_out, model, max_norm, frozen=()):
    """Each gradient within 1e-3 of its tensor's largest (the JAX side's
    scaled by the clip the port applied).  A tensor whose exact gradient
    is 0 (a bias feeding a train-mode BatchNorm) holds rounding noise on
    both sides: below 1e-6 of the step's largest, the port's must be too.
    Returns how many tensors were compared."""
    scale = min(1.0, max_norm / jax_out['grad_norm'])
    want = state_dict_from_jax(jax_out['grads'], {})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    largest = max(np.abs(w.numpy()).max() for w in want.values()) * scale
    compared = 0
    for name, p in params.items():
        w = want[name].numpy() * scale
        if name.startswith(frozen):
            assert p.grad is None and not np.any(w), name
            continue
        got = p.grad.numpy()
        assert np.isfinite(got).all(), name
        if np.abs(w).max() < 1e-6 * largest:
            assert np.abs(got).max() < 1e-6 * largest, name
            continue
        err = np.abs(got - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (name, err, np.abs(w).max())
        compared += 1
    return compared


def check_batch_stats(jax_out, model):
    # the parameters' names tell the converter the model's layout
    want = state_dict_from_jax(jax_out['grads'], jax_out['batch_stats'])
    got = model.state_dict()
    n = 0
    for key, w in want.items():
        if key.endswith(('running_mean', 'running_var')):
            assert rel(got[key], w) < 1e-5, key
            n += 1
    return n


@pytest.fixture(scope='module')
def step_inputs():
    """(the JAX model, its batch, params, stats, the torch batch, the
    config, the full config) of the steps."""
    full, cfg = tiny_train_cfg('synthetic/fcaf3d_tiny.py')
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = train_batch(zoo.synth_fcaf3d_batch, b=2, p=1024, g=4, seed=0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = jax_variables(jmodel, jbatch)
    return jmodel, jbatch, params, stats, batch, cfg, full


@pytest.fixture(scope='module')
def step_pair(step_inputs):
    """(JAX step, the port's model after its step, its metrics, the
    config)."""
    jmodel, jbatch, params, stats, batch, cfg, full = step_inputs
    jax_out = jax_train_step(jmodel, unflatten_params(params),
                             unflatten_params(stats), jbatch)
    model, metrics = port_train_step(cfg, full, params, stats, batch)
    return jax_out, model, metrics, full


@pytest.fixture(scope='module')
def bf16_step_pair(step_inputs):
    """The same step under the bf16 policy: (JAX's bf16 step, the port's
    model after its bf16 step, its metrics)."""
    jmodel, jbatch, params, stats, batch, cfg, full = step_inputs
    jax_out = jax_train_step(jmodel, unflatten_params(params),
                             unflatten_params(stats), jbatch, 'bfloat16')
    model, metrics = port_train_step(cfg, full, params, stats, batch,
                                     bf16=True)
    return jax_out, model, metrics


def test_train_step_losses_match_jax(step_pair):
    jax_out, _, metrics, _ = step_pair
    check_losses(jax_out, metrics)


def test_train_step_grads_match_jax(step_pair):
    jax_out, model, _, full = step_pair
    max_norm = full.optimizer_config['grad_clip']['max_norm']
    assert check_grads(jax_out, model, max_norm) > 40


def test_train_step_batch_stats_match_jax(step_pair):
    assert check_batch_stats(step_pair[0], step_pair[1]) > 40


# the bf16 step against the JAX package's own bf16 - float32 gap (the
# module docstring): losses, BatchNorm statistics, the backbone's and the
# head's gradients
BF16_LOSS_GAPS = 4.0
BF16_STATS_GAPS = 2.0
BF16_GRAD_GAPS = 1.5


def test_bf16_train_step_losses_follow_jax(step_pair, bf16_step_pair):
    jax32, _, metrics32, _ = step_pair
    jax16, _, metrics = bf16_step_pair
    assert set(metrics) == set(jax16['losses']) | {'loss', 'grad_norm'}
    gap = max(rel(jax16['losses'][k], w) for k, w in
              jax32['losses'].items())
    for key, w in jax16['losses'].items():
        assert float(w) > 0, key
        assert metrics[key].dtype == torch.float32
        assert rel(metrics[key], w) <= BF16_LOSS_GAPS * gap, (
            key, rel(metrics[key], w), gap)
        assert rel(metrics[key], metrics32[key]) > 0, key   # bf16 ran


def test_bf16_train_step_batch_stats_follow_jax(step_pair, bf16_step_pair):
    jax32 = step_pair[0]
    jax16, model, _ = bf16_step_pair
    want = state_dict_from_jax(jax16['grads'], jax16['batch_stats'])
    ref = state_dict_from_jax(jax32['grads'], jax32['batch_stats'])
    stats = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    gap = max(rel(want[k], ref[k]) for k in stats)
    got = model.state_dict()
    assert len(stats) > 40 and gap > 0
    for key in stats:
        assert got[key].dtype == torch.float32, key
        assert rel(got[key], want[key]) <= BF16_STATS_GAPS * gap, key


def grad_l2(got, want, names):
    """The error of the gradients ``names`` taken as one vector, of its
    norm."""
    num = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in names)
    return (num / sum(float(np.sum(want[n] ** 2)) for n in names)) ** 0.5


@pytest.mark.parametrize('part', ['backbone', 'head'])
def test_bf16_train_step_grads_follow_jax(step_pair, bf16_step_pair, part):
    """A part's gradients as one vector (each side's unclipped): the
    port's bf16 step within ``BF16_GRAD_GAPS`` of the JAX package's own
    bf16 - float32 gap from JAX's bf16 step, and its own gap within a third
    and three times JAX's (the policy ran, and rounds about as much).  The
    master weights' gradients are float32."""
    jax32, model32, metrics32, full = step_pair
    jax16, model, metrics = bf16_step_pair
    max_norm = full.optimizer_config['grad_clip']['max_norm']

    def grads(m, norm):
        scale = max(float(norm) / max_norm, 1.0)
        return {n: p.grad.numpy() * scale for n, p in m.named_parameters()}

    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    got = grads(model, metrics['grad_norm'])
    own32 = grads(model32, metrics32['grad_norm'])
    want = {k: v.numpy() for k, v in
            state_dict_from_jax(jax16['grads'], {}).items()}
    ref = {k: v.numpy() for k, v in
           state_dict_from_jax(jax32['grads'], {}).items()}
    names = [n for n in got if n.startswith(part)]
    assert len(names) > 20
    gap = grad_l2(want, ref, names)
    own = grad_l2(got, own32, names)
    assert grad_l2(got, want, names) <= BF16_GRAD_GAPS * gap, (
        grad_l2(got, want, names), gap)
    assert gap / 3 <= own <= 3 * gap, (own, gap)


@pytest.mark.parametrize('empty_scene', [False, True])
def test_masked_batch_norm_train_equals_jax(empty_scene):
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 50, 6) * 3 + 1).astype(np.float32)
    valid = rng.rand(2, 50) < 0.7
    if empty_scene:
        valid[1] = False
    x *= valid[..., None]
    jbn = JaxBatchNorm()
    variables = {'params': {'scale': rng.rand(6).astype(np.float32) + 0.5,
                            'bias': rng.randn(6).astype(np.float32)},
                 'batch_stats': {'mean': rng.randn(6).astype(np.float32),
                                 'var': rng.rand(6).astype(np.float32) + 1}}
    want, mutated = jbn.apply(variables, jnp.asarray(x), jnp.asarray(valid),
                              True, mutable=['batch_stats'])
    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        bn.bn.weight.copy_(torch.from_numpy(variables['params']['scale']))
        bn.bn.bias.copy_(torch.from_numpy(variables['params']['bias']))
        bn.bn.running_mean.copy_(torch.from_numpy(
            variables['batch_stats']['mean']))
        bn.bn.running_var.copy_(torch.from_numpy(
            variables['batch_stats']['var']))
    got = bn.train()(torch.from_numpy(x), torch.from_numpy(valid))
    assert rel(got.detach(), want) < 1e-5
    assert rel(bn.bn.running_mean, mutated['batch_stats']['mean']) < 1e-5
    assert rel(bn.bn.running_var, mutated['batch_stats']['var']) < 1e-5


def target_case(seed):
    """Points in and around 6 boxes, each voxel at a random level."""
    rng = np.random.RandomState(seed)
    b, n, g = 2, 600, 6
    points = rng.uniform(-2, 2, (b, n, 3)).astype(np.float32)
    levels = rng.randint(0, 4, n).astype(np.int32)
    pt_valid = rng.rand(b, n) < 0.9
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :3] = rng.uniform(-1.5, 1.5, (b, g, 3))
    boxes[..., 3:6] = rng.uniform(0.5, 2.0, (b, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    labels = rng.randint(0, 10, (b, g)).astype(np.int32)
    gt_valid = rng.rand(b, g) < 0.8
    return points, levels, pt_valid, boxes, labels, gt_valid


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_get_targets_equal_jax(seed):
    case = target_case(seed)
    head_cfg = dict(in_channels=(16, 32, 64, 128), out_channels=32,
                    pts_assign_threshold=8, pts_center_threshold=6)
    jhead = build_from_cfg(dict(head_cfg, type='FCAF3DHead'),
                           __import__('demf_tpu.utils.registry',
                                      fromlist=['HEADS']).HEADS,
                           {'parent': None})
    want = [jax.device_get(jhead.get_targets(
        case[0][i], jnp.asarray(case[1]), case[2][i], case[3][i], case[4][i],
        case[5][i])) for i in range(2)]
    head = FCAF3DHead(**head_cfg)
    got = head.get_targets(*(torch.from_numpy(a) for a in (
        case[0], case[1].astype(np.int64), case[2], case[3], case[4],
        case[5])))
    pos = 0
    for i, (cent, box, lab) in enumerate(want):
        assert np.array_equal(got[2][i].numpy(), lab)
        assert np.array_equal(got[1][i].numpy(), box)
        assert np.abs(got[0][i].numpy() - cent).max() <= 1e-6
        pos += int((lab >= 0).sum())
    assert pos > 10


def iou_case():
    """Decoded boxes against targets: random pairs, pairs with parallel
    edges (the same yaw, shifted along an edge), and the loss's dummy rows
    (a box against a copy of itself, weighing 0)."""
    rng = np.random.RandomState(5)
    n = 24
    a = np.zeros((n, 7), np.float32)
    a[:, :3] = rng.uniform(-1, 1, (n, 3))
    a[:, 3:6] = rng.uniform(0.3, 1.5, (n, 3))
    a[:, 6] = rng.uniform(-np.pi, np.pi, n)
    t = a.copy()
    t[:8, :3] += rng.uniform(-0.3, 0.3, (8, 3))
    t[:8, 3:6] *= rng.uniform(0.7, 1.3, (8, 3))
    t[:8, 6] += rng.uniform(-0.5, 0.5, 8)
    t[8:16, 0] += 0.2                     # parallel edges, shifted
    t[8:16, 3] *= 1.1
    w = np.ones(n, np.float32)
    w[16:] = 0                            # the dummy rows: a box and itself
    return a, t, w


def test_iou3d_aligned_grad_equals_jax():
    a, t, w = iou_case()

    def jloss(x):
        return jnp.sum((1 - jax_iou3d_aligned(
            x, jax.lax.stop_gradient(jnp.asarray(t)))) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_()
    ((1 - iou3d_aligned(x, torch.from_numpy(t))) * torch.from_numpy(w)
     ).sum().backward()
    assert torch.isfinite(x.grad).all()
    assert (x.grad[16:] == 0).all()
    assert np.abs(want[:16]).max() > 0
    assert rel(x.grad, want) <= 1e-4


def test_dummy_rows_keep_the_decode_finite():
    """A voxel that is no positive decodes the dummy prediction against
    itself: its IoU loss and gradient (weighted 0) stay finite."""
    head = FCAF3DHead()
    pred = torch.tensor([DUMMY_BBOX_PRED] * 3, requires_grad=True)
    points = torch.zeros(3, 3)
    box = head.bbox_pred_to_bbox(points, pred)
    iou = iou3d_aligned(box, box.detach())
    assert torch.allclose(iou, torch.ones(3), atol=1e-5)
    (iou * 0).sum().backward()
    assert torch.isfinite(pred.grad).all()
