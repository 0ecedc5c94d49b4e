"""The port's image-only Faster R-CNN (``ImVoteNet`` without points) and
its training half against the JAX package's, on the CPU.

* ``rpn_loss`` over every anchor of a 64x96 image's five levels,
  ``sample_rcnn_rois`` (RoIs, labels, GT boxes and masks equal) and
  ``rcnn_loss`` on the same inputs and the same draws (the JAX side's keys
  split as its functions split them, the uniforms handed to the port):
  within 1e-5 relative;
* the RoIAlign's gradient with respect to the levels: the plain version's
  autograd against ``jax.vjp`` of ``pyramid_roi_align`` within 1e-5 of the
  largest, and K12's rule (the sample table's clamped corners and weights,
  scatter-added) against that autograd;
* the tiny model of the JAX tests' ``test_frcnn_image_only_training`` on
  the same weights, batch and draws: each image-only loss within 1e-4
  relative, the gradients of the RPN, the RoI head and the FPN within 1e-3
  of each tensor's largest (the JAX side's proposals fed into the port's
  RoI half, since float ties in random RPN scores could reorder them), and
  the inference's R-CNN detections;
* ``demf_tpu_torch/configs/imvotenet_frcnn_tiny.py`` through the train
  entry (dataset and synthetic modes), its checkpoint warm-starting the
  tiny stage-2 ImVoteNet with no key of its 2D branch missing;
* under the bf16 policy, on JAX's bf16 proposals and draws: the sampled
  RoIs equal, each loss term within 3e-2 relative, each gradient of the
  RPN, the RoI head and the FPN within twice the largest difference JAX's
  own bf16 step makes from its float32 step in that branch;
* the RoIAlign on bf16 levels: its float32 output against JAX's gather,
  and its bf16 gradient equal to the float32 one rounded once (K12's
  order on the card) and within twice JAX's own bf16 - float32 gap of
  JAX's gradient, which rounds each corner's share.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.models import rpn_roi as jrpn
from demf_tpu.utils import precision as jprec
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import train, zoo
from demf_tpu_torch.engine import (batch_to_device, latest_checkpoint,
                                   load_weights, state_dict_from_jax)
from demf_tpu_torch.models import imvotenet, rpn_roi
from demf_tpu_torch.ops import roi_align
from demf_tpu_torch.utils import precision as prec
from demf_tpu_torch.utils.config import Config
from test_detr_imvotenet import img_only_batch
from test_rpn_roi import tiny_imvotenet_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(ROOT, 'demf_tpu_torch', 'configs',
                        'imvotenet_frcnn_tiny.py')
STAGE2_CFG = os.path.join(ROOT, 'demf_tpu_torch', 'configs',
                          'imvotenet_tiny.py')
LEVELS = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))   # a 64x96 image's
STRIDES = (4, 8, 16, 32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def jax_frcnn_cfg():
    """``tests/test_rpn_roi.py::test_frcnn_image_only_training``'s model:
    the tiny ImVoteNet with small proposal and sampler budgets."""
    cfg = tiny_imvotenet_cfg()
    tc = dict(cfg['train_cfg'])
    tc['img_rpn_proposal'] = dict(nms_pre=16, max_per_img=16,
                                  nms=dict(type='nms', iou_threshold=0.7))
    tc['img_rcnn'] = dict(
        assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.5,
                      neg_iou_thr=0.5, min_pos_iou=0.5,
                      match_low_quality=False),
        sampler=dict(type='RandomSampler', num=16, pos_fraction=0.25))
    tc['img_rpn'] = dict(
        assigner=dict(type='MaxIoUAssigner', pos_iou_thr=0.7,
                      neg_iou_thr=0.3, min_pos_iou=0.3,
                      match_low_quality=True),
        sampler=dict(type='RandomSampler', num=32, pos_fraction=0.5))
    cfg['train_cfg'] = tc
    return cfg


def sample_draws(key, n):
    """``random_sample``'s positive and negative uniforms of ``key``."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


def rpn_draws(rng, b, n):
    """The uniforms ``rpn_loss`` draws from ``rng`` for ``b`` images of
    ``n`` anchors -> dict(rpn_pos, rpn_neg) of (b, n)."""
    draws = [sample_draws(k, n) for k in jax.random.split(rng, b)]
    return {name: torch.from_numpy(np.stack([d[i] for d in draws]))
            for i, name in enumerate(('rpn_pos', 'rpn_neg'))}


def rcnn_draws(rng, b, n):
    """The uniforms ``sample_rcnn_rois`` draws from ``rng`` -> dict(
    rcnn_pos, rcnn_neg, rcnn_order) of (b, n)."""
    out = {name: [] for name in imvotenet.FRCNN_DRAWS[2:]}
    for key in jax.random.split(rng, b):
        pos, neg = sample_draws(key, n)
        out['rcnn_pos'].append(pos)
        out['rcnn_neg'].append(neg)
        out['rcnn_order'].append(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 1), (n,))))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def gt_case(rng, b=2, g=5, hw=(64, 96)):
    h, w = hw
    boxes = np.zeros((b, g, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, w / 2, (b, g))
    boxes[..., 1] = rng.uniform(0, h / 2, (b, g))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(8, w / 2, (b, g))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(8, h / 2, (b, g))
    valid = np.ones((b, g), bool)
    valid[1, 3:] = False
    return boxes, rng.randint(0, 10, (b, g)), valid


def test_rpn_loss_matches_jax():
    rng = np.random.RandomState(0)
    outs = [(rng.randn(2, h, w, 3).astype(np.float32),
             (rng.randn(2, h, w, 12) * 0.3).astype(np.float32))
            for h, w in LEVELS]
    gt, _, valid = gt_case(rng)
    model = jax_frcnn_cfg()
    rpn_cfg = model['img_rpn_head']
    args = (dict(rpn_cfg['anchor_generator']), dict(rpn_cfg['bbox_coder']))
    cfgs = (dict(model['train_cfg']['img_rpn']), dict(rpn_cfg['loss_cls']),
            dict(rpn_cfg['loss_bbox']))
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda o, g, v, k: jrpn.rpn_loss(o, *args, g, v, *cfgs,
                                                    k))(
        [tuple(jnp.asarray(x) for x in o) for o in outs], jnp.asarray(gt),
        jnp.asarray(valid), key)
    n = sum(h * w * 3 for h, w in LEVELS)
    draws = rpn_draws(key, 2, n)
    got = rpn_roi.rpn_loss(
        [tuple(torch.from_numpy(x) for x in o) for o in outs], *args,
        torch.from_numpy(gt), torch.from_numpy(valid), *cfgs,
        u_pos=draws['rpn_pos'], u_neg=draws['rpn_neg'])
    assert set(got) == set(want) == {'loss_rpn_cls', 'loss_rpn_bbox'}
    for k in want:
        assert float(want[k]) > 0
        assert _rel(got[k].item(), float(want[k])) < 1e-5, k


@pytest.fixture(scope='module')
def rcnn_pair():
    """``sample_rcnn_rois`` and ``rcnn_loss`` in both packages on 16
    proposals (3 invalid) and 5 GT slots an image."""
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 60, (2, 16, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 40, (2, 16, 2))],
                           -1).astype(np.float32)
    gt, labels, gvalid = gt_case(rng)
    props[:, :5] = gt + rng.uniform(-2, 2, gt.shape).astype(np.float32)
    pvalid = np.ones((2, 16), bool)
    pvalid[0, -3:] = False
    cfg = jax_frcnn_cfg()
    train_cfg = dict(cfg['train_cfg']['img_rcnn'])
    head = cfg['img_roi_head']['bbox_head']
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda *a: jrpn.sample_rcnn_rois(*a, train_cfg, 10,
                                                     key))(
        jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(gvalid))
    draws = rcnn_draws(key, 2, 21)
    got = rpn_roi.sample_rcnn_rois(
        torch.from_numpy(props), torch.from_numpy(pvalid),
        torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(gvalid), train_cfg, 10, u_pos=draws['rcnn_pos'],
        u_neg=draws['rcnn_neg'], u_order=draws['rcnn_order'])
    cls = rng.randn(2, 16, 11).astype(np.float32)
    deltas = rng.randn(2, 16, 40).astype(np.float32)
    loss_args = (dict(head['bbox_coder']), 10, dict(head['loss_cls']),
                 dict(head['loss_bbox']))
    want_loss = jrpn.rcnn_loss(jnp.asarray(cls), jnp.asarray(deltas), want,
                               *loss_args)
    got_loss = rpn_roi.rcnn_loss(torch.from_numpy(cls),
                                 torch.from_numpy(deltas), got, *loss_args)
    return want, got, want_loss, got_loss


def test_sample_rcnn_rois_matches_jax(rcnn_pair):
    want, got, _, _ = rcnn_pair
    assert set(got) == set(want)
    for k in ('labels', 'pos', 'chosen'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ('rois', 'gt_boxes'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got['pos'].any() and (got['chosen'] & ~got['pos']).any()


def test_rcnn_loss_matches_jax(rcnn_pair):
    _, _, want, got = rcnn_pair
    assert set(got) == set(want) == {'loss_cls', 'loss_bbox'}
    for k in want:
        assert float(want[k]) > 0
        assert _rel(got[k].item(), float(want[k])) < 1e-5, k


def roi_grad_case(seed=0, b=2, r=60, c=8):
    """Levels of a 64x96 image, RoIs of every size and on every level,
    some across and beyond the borders (corners that clamp), and d_out."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, 64 // s, 96 // s, c).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(-20, 100, (b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(1000), (b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :4] = [[-8, -8, 10, 12], [80, 50, 110, 80], [0, 0, 96, 64],
                   [95, 63, 96, 64]]
    lvl = roi_align.roi_levels(torch.from_numpy(rois), 4)
    lvl[:, ::4] = torch.arange(4).repeat(r // 16 + 1)[:lvl[:, ::4].shape[1]]
    d_out = rng.randn(b, r, 7, 7, c).astype(np.float32)
    return feats, rois, lvl, d_out


def test_plain_roi_align_gradient_matches_jax():
    feats, rois, lvl, d_out = roi_grad_case()
    _, vjp = jax.vjp(jax.jit(lambda fs: jax.vmap(
        lambda f, r, l: jrpn.pyramid_roi_align(f, r, l, STRIDES, 7))(
            fs, jnp.asarray(rois), jnp.asarray(lvl.numpy()))),
        tuple(jnp.asarray(f) for f in feats))
    want = vjp(jnp.asarray(d_out))[0]
    got = roi_align.pyramid_roi_align_backward_plain(
        torch.from_numpy(d_out), [f.shape for f in feats],
        torch.from_numpy(rois), lvl, STRIDES, 7)
    largest = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * largest


def k12_rule(d_out, shapes, rois, lvl, strides, out=7, s=2):
    """K12 in plain torch: each RoI's sample table (``sample_table``: the
    clamped near and far corner of every sample on each axis and their
    weights), every sample's share ``d_out / (s * s)`` times its corner's
    weights added into the corner's pixel."""
    table = roi_align.sample_table(rois, lvl, strides,
                                   [sh[1:3] for sh in shapes], out, s)
    (y0, y1, wy1, wy0), (x0, x1, wx1, wx0) = table['y'], table['x']
    b, r = rois.shape[:2]
    share = (d_out / (s * s)).repeat_interleave(s, 2).repeat_interleave(
        s, 3)                                        # (B, R, out s, out s, C)
    grads = [torch.zeros(sh) for sh in shapes]
    scene = torch.arange(b)[:, None, None, None].expand(b, r, out * s,
                                                        out * s)
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            w = wy[..., :, None] * wx[..., None, :]
            val = share * w[..., None]
            for level, g in enumerate(grads):
                on = (lvl.long() == level)[..., None, None].expand_as(w)
                g.index_put_((scene[on], yi[..., :, None].expand_as(w)[on],
                              xi[..., None, :].expand_as(w)[on]),
                             val[on], accumulate=True)
    return grads


def test_k12_rule_equals_the_plain_autograd():
    feats, rois, lvl, d_out = roi_grad_case(seed=2)
    shapes = [f.shape for f in feats]
    want = roi_align.pyramid_roi_align_backward_plain(
        torch.from_numpy(d_out), shapes, torch.from_numpy(rois), lvl,
        STRIDES, 7)
    got = k12_rule(torch.from_numpy(d_out), shapes, torch.from_numpy(rois),
                   lvl, STRIDES)
    largest = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * largest


def perturbed(variables, rng):
    params = {k: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) *
              0.02 for k, v in flatten_params(variables['params']).items()}
    stats = {k: (rng.randn(*v.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
             for k, v in flatten_params(variables['batch_stats']).items()}
    return params, stats


@pytest.fixture(scope='module')
def model_pair():
    """The tiny image-only model in both packages on the same weights and
    batch: JAX's training losses, gradients and drawn keys, the proposals
    its R-CNN sampled from, and its inference detections (one jit); the
    port's losses and gradients on JAX's draws and proposals, and its
    detections."""
    jmodel = build_from_cfg(jax_frcnn_cfg(), JAX_DETECTORS)
    batch = jax.tree_util.tree_map(np.array,
                                   img_only_batch(np.random.RandomState(5)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda r, b: jmodel.init(
        {'params': r, 'sample': r}, b, train=False), jax.random.PRNGKey(0),
        jbatch)
    rng = np.random.RandomState(0)
    params, stats = perturbed(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), rng)
    for key, v in params.items():     # fan-in scaled random weights
        if key.endswith('kernel'):
            params[key] = (rng.randn(*v.shape) / np.sqrt(
                np.prod(v.shape[:-1]))).astype(np.float32)
        elif key.endswith('scale'):
            params[key] = v + 1.0
    jstats = unflatten_params(stats)
    sampled_from = {}
    original = jrpn.sample_rcnn_rois

    def sample_rcnn_rois(proposals, valid, *args):
        out = original(proposals, valid, *args)
        return dict(out, rng=args[-1], proposals=proposals,
                    proposal_valid=valid)

    def loss_fn(p, b):
        results, _ = jmodel.apply(
            {'params': p, 'batch_stats': jstats}, b, train=True,
            mutable=['batch_stats'], rngs={'sample': jax.random.PRNGKey(4)})
        losses = jmodel.loss(results, b)
        return sum(losses.values()), (results, losses)

    @jax.jit
    def run(p, b):
        (_, (results, losses)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, b)
        eval_results = jmodel.apply({'params': p, 'batch_stats': jstats}, b,
                                    train=False)
        return (results['sample_rng'], results['rcnn_sampled'], losses,
                grads, jmodel.get_bboxes(eval_results, b))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrpn, 'sample_rcnn_rois', sample_rcnn_rois)
        rpn_rng, sampled, losses, grads, det = jax.device_get(
            run(unflatten_params(params), jbatch))
    sampled_from.update(sampled)

    model = zoo.build_detector(zoo.tiny_frcnn_model_cfg(), 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    tbatch = batch_to_device(batch, 'cpu')
    n_anchors = sum(h * w * 3 for h, w in LEVELS)
    draws = dict(rpn_draws(rpn_rng, 2, n_anchors),
                 **rcnn_draws(sampled['rng'], 2, 16 + 4))
    proposals = (torch.from_numpy(sampled['proposals']), None,
                 torch.from_numpy(sampled['proposal_valid']))
    model.train()
    with pytest.MonkeyPatch.context() as mp, \
            torch.backends.mkldnn.flags(enabled=False):
        mp.setattr(model.img_rpn_head, 'get_proposals',
                   lambda *a: proposals)
        results = model(tbatch, draws=draws)
        got_losses = model.loss(results, tbatch)
        sum(got_losses.values()).backward()
    model.eval()
    with torch.no_grad():
        got_det = model.get_bboxes(model(tbatch), tbatch)
    return dict(jax=dict(losses=losses, grads=flatten_params(grads),
                         sampled=sampled, det=det, params=params,
                         stats=stats),
                port=dict(losses=got_losses, results=results, model=model,
                          det=got_det))


def test_tiny_model_cfg_is_the_jax_tests_without_points():
    want = jax_frcnn_cfg()
    for key in ('pts_backbone', 'pts_bbox_heads', 'img_mlp', 'fusion_layer',
                'num_sampled_seed'):
        want.pop(key)
    want['freeze_img_branch'] = False
    want['train_cfg'] = {k: v for k, v in want['train_cfg'].items()
                         if k != 'pts'}
    want['test_cfg'] = {k: v for k, v in want['test_cfg'].items()
                        if k != 'pts'}
    assert zoo.tiny_frcnn_model_cfg() == want
    assert dict(Config.fromfile(TINY_CFG).model) == want


def test_image_only_sampling_matches_jax(model_pair):
    want, got = model_pair['jax']['sampled'], model_pair['port']['results']
    for k in ('labels', 'pos', 'chosen', 'rois', 'gt_boxes'):
        np.testing.assert_array_equal(got['rcnn_sampled'][k].numpy(),
                                      np.asarray(want[k]))
    assert got['rcnn_sampled']['pos'].any()


def test_image_only_losses_match_jax(model_pair):
    want, got = model_pair['jax']['losses'], model_pair['port']['losses']
    assert set(got) == set(want) == {'loss_rpn_cls', 'loss_rpn_bbox',
                                     'loss_cls', 'loss_bbox'}
    for k, w in want.items():
        assert float(w) > 0, k
        assert _rel(got[k].item(), float(w)) < 1e-4, k


@pytest.mark.parametrize('branch', ['img_rpn_head', 'img_roi_head',
                                    'img_neck'])
def test_image_only_gradients_match_jax(model_pair, branch):
    """Each gradient of the branch within 1e-3 of that tensor's largest
    (a tensor whose gradient is noise beside the branch's largest must be
    noise on both sides)."""
    grads = state_dict_from_jax(
        {k: v for k, v in model_pair['jax']['grads'].items()
         if k.startswith(branch)}, {})
    params = {n: p for n, p in model_pair['port']['model'].named_parameters()
              if n.startswith(branch)}
    assert set(grads) == set(params) and params
    largest = max(np.abs(w.numpy()).max() for w in grads.values())
    assert largest > 0
    for name, p in params.items():
        w = grads[name].numpy()
        g = p.grad.numpy()
        if np.abs(w).max() < 1e-6 * largest:
            assert np.abs(g).max() < 1e-6 * largest, name
            continue
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), name


def test_image_only_inference_matches_jax(model_pair):
    want, got = model_pair['jax']['det'], model_pair['port']['det']
    assert set(got) == set(want) == {'bboxes', 'labels', 'valid'}
    valid = np.asarray(want['valid'])
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    assert valid.any()
    np.testing.assert_array_equal(got['labels'].numpy()[valid],
                                  np.asarray(want['labels'])[valid])
    assert np.abs(got['bboxes'].numpy()[valid] -
                  np.asarray(want['bboxes'])[valid]).max() < 1e-4 * 96


def test_image_only_training_draws_from_a_generator():
    """Without draws the samplers take the generator's uniforms in the
    order of ``FRCNN_DRAWS``; the same generator state, the same losses;
    with neither, training refuses."""
    model = zoo.build_detector(zoo.tiny_frcnn_model_cfg(), 'cpu').train()
    batch = batch_to_device(zoo.synth_batch_for(model, b=2, g=4,
                                                hw=(64, 96)), 'cpu')
    with torch.no_grad():
        first = model.loss(model(batch, generator=torch.Generator()
                                 .manual_seed(3)), batch)
        again = model.loss(model(batch, generator=torch.Generator()
                                 .manual_seed(3)), batch)
        assert all(torch.equal(first[k], again[k]) for k in first)
        with pytest.raises(ValueError, match='torch.Generator'):
            model(batch)


def test_synth_batch_of_a_pointless_imvotenet():
    model = zoo.build_detector(zoo.tiny_frcnn_model_cfg(), 'cpu')
    batch = zoo.synth_batch_for(model, b=1)
    assert batch['img'].shape == (1, 608, 832, 3)
    assert batch['gt_bboxes'].shape == (1, 64, 4) and 'points' not in batch
    assert zoo.synth_batch_for(model, b=1, hw=(64, 96))['img'].shape == (
        1, 64, 96, 3)


def test_train_entry_and_warm_start_of_stage_2(tmp_path, capsys):
    """The train entry on the tiny config (an epoch of 2 steps on the
    dataset, then 2 synthetic steps), and its checkpoint warm-starting the
    tiny stage-2 ImVoteNet: no key of the 2D branch missing, none
    unexpected."""
    work = str(tmp_path / 'wd')
    train.main([TINY_CFG, '--device', 'cpu', '--work-dir', work])
    out = capsys.readouterr().out
    assert out.count('Epoch [1/1]') == 2 and 'loss_rpn_cls' in out
    ckpt = latest_checkpoint(work)
    assert ckpt.endswith('epoch_1.pth')
    stage2 = zoo.build_detector(Config.fromfile(STAGE2_CFG).model, 'cpu')
    missing, unexpected = load_weights(ckpt, stage2)
    assert unexpected == []
    assert not [k for k in missing if k.startswith(stage2.img_branch)]
    state = torch.load(ckpt, weights_only=True)['state_dict']
    for key, value in stage2.state_dict().items():
        if key.startswith(stage2.img_branch):
            assert torch.equal(value, state[key]), key
    train.main([TINY_CFG, '--device', 'cpu', '--synthetic', '--steps', '2',
                '--batch', '2', '--hw', '64', '96', '--gt', '4'])
    assert capsys.readouterr().out.count('loss_cls') == 2


# -- under the bf16 policy ---------------------------------------------------

@pytest.fixture(scope='module')
def bf16_model_pair(model_pair):
    """``model_pair``'s training step under the bf16 policy in both
    packages: JAX's as ``make_train_step(compute_dtype='bfloat16')`` runs
    it (the results cast to float32 before the loss), the port's through
    ``policy_call`` on bf16 copies of the float32 weights, on JAX's bf16
    proposals and draws."""
    jmodel = build_from_cfg(jax_frcnn_cfg(), JAX_DETECTORS)
    params, stats = model_pair['jax']['params'], model_pair['jax']['stats']
    batch = jax.tree_util.tree_map(np.array,
                                   img_only_batch(np.random.RandomState(5)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstats = unflatten_params(stats)
    original = jrpn.sample_rcnn_rois

    def sample_rcnn_rois(proposals, valid, *args):
        out = original(proposals, valid, *args)
        return dict(out, rng=args[-1], proposals=proposals,
                    proposal_valid=valid)

    def loss_fn(p, b):
        with jprec.compute_dtype_scope('bfloat16'):
            results, _ = jmodel.apply(
                {'params': jprec.cast_floating(p, jnp.bfloat16),
                 'batch_stats': jstats}, jprec.cast_batch(b, jnp.bfloat16),
                train=True, mutable=['batch_stats'],
                rngs={'sample': jax.random.PRNGKey(4)})
        results = jprec.cast_floating(results, 'float32')
        losses = jmodel.loss(results, b)
        return sum(losses.values()), (results, losses)

    @jax.jit
    def run(p, b):
        (_, (results, losses)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, b)
        return results['sample_rng'], results['rcnn_sampled'], losses, grads

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrpn, 'sample_rcnn_rois', sample_rcnn_rois)
        rpn_rng, sampled, losses, grads = jax.device_get(
            run(unflatten_params(params), jbatch))

    model = zoo.build_detector(zoo.tiny_frcnn_model_cfg(), 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    tbatch = batch_to_device(batch, 'cpu')
    n_anchors = sum(h * w * 3 for h, w in LEVELS)
    draws = dict(rpn_draws(rpn_rng, 2, n_anchors),
                 **rcnn_draws(sampled['rng'], 2, 16 + 4))
    proposals = (torch.tensor(sampled['proposals']), None,
                 torch.tensor(sampled['proposal_valid']))
    model.train()
    with pytest.MonkeyPatch.context() as mp, \
            torch.backends.mkldnn.flags(enabled=False):
        mp.setattr(model.img_rpn_head, 'get_proposals',
                   lambda *a: proposals)
        results = prec.cast_floating(prec.policy_call(
            model, torch.bfloat16, prec.cast_batch(tbatch, torch.bfloat16),
            draws=draws), torch.float32)
        got_losses = model.loss(results, tbatch)
        sum(got_losses.values()).backward()
    return dict(jax=dict(losses=losses, grads=flatten_params(grads),
                         sampled=sampled),
                port=dict(losses=got_losses, results=results, model=model))


def test_image_only_sampling_under_the_policy_matches_jax(bf16_model_pair):
    """On JAX's bf16 proposals and draws the same RoIs are sampled (the
    sampler's IoUs are float32 under the policy in both packages)."""
    want = bf16_model_pair['jax']['sampled']
    got = bf16_model_pair['port']['results']['rcnn_sampled']
    for k in ('labels', 'pos', 'chosen', 'rois', 'gt_boxes'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got['rois'].dtype == torch.float32


def test_image_only_losses_under_the_policy_match_jax(model_pair,
                                                      bf16_model_pair):
    """Each loss term within 3e-2 relative of JAX's under the policy, and
    within twice JAX's own bf16 - float32 gap of it where that gap is
    larger."""
    want = bf16_model_pair['jax']['losses']
    want32 = model_pair['jax']['losses']
    got = bf16_model_pair['port']['losses']
    assert set(got) == set(want)
    for k, w in want.items():
        gap = _rel(float(w), float(want32[k]))
        assert _rel(got[k].item(), float(w)) <= max(3e-2, 2 * gap), k


@pytest.mark.parametrize('branch', ['img_rpn_head', 'img_roi_head',
                                    'img_neck'])
def test_image_only_gradients_under_the_policy_match_jax(
        model_pair, bf16_model_pair, branch):
    """Each float32 master's gradient of the branch within twice the
    largest difference JAX's own bf16 step makes from its float32 step in
    that branch (seen: a tensor's port - JAX difference 0.2 to 1.1 times
    that gap; tensor by tensor the port's bf16 - float32 gap is 0.2 to 3.5
    times JAX's: the levels' gradient, K12's on the card, is summed in
    float32 and rounded once where JAX rounds each corner's share to bf16,
    and XLA keeps some products in float32 that torch rounds), a tensor
    whose gradient is noise beside the branch's largest noise on both
    sides."""
    grads, grads32 = (state_dict_from_jax(
        {k: v for k, v in g.items() if k.startswith(branch)}, {})
        for g in (bf16_model_pair['jax']['grads'],
                  model_pair['jax']['grads']))
    params = {n: p for n, p in
              bf16_model_pair['port']['model'].named_parameters()
              if n.startswith(branch)}
    assert set(grads) == set(params) and params
    largest = max(np.abs(w.numpy()).max() for w in grads.values())
    gap = max(np.abs(grads[k].numpy() - grads32[k].numpy()).max()
              for k in grads)
    assert gap > 1e-3 * largest
    for name, p in params.items():
        assert p.grad.dtype == torch.float32
        w, g = grads[name].numpy(), p.grad.numpy()
        if np.abs(w).max() < 1e-6 * largest:
            assert np.abs(g).max() < 1e-6 * largest, name
            continue
        assert np.abs(g - w).max() <= 2 * gap, name


@pytest.mark.parametrize('seed', [0, 3])
def test_plain_roi_align_on_bf16_levels_matches_jax(seed):
    """The RoIAlign on bf16 levels: the output float32, within 1e-5 of the
    largest of JAX's gather of the bf16 corners weighed in float32 (XLA
    fuses the products), and equal to the float32 RoIAlign of the widened
    levels; the levels' gradient bf16, equal to the
    float32 gradient rounded once (the port's order, K12's on the card),
    and within twice JAX's own bf16 - float32 gap of JAX's bf16 gradient,
    whose scatter rounds each corner's share."""
    feats, rois, lvl, d_out = roi_grad_case(seed=seed)
    bf = [torch.from_numpy(f).to(torch.bfloat16).requires_grad_()
          for f in feats]
    f32 = [f.detach().float() for f in bf]
    trois = torch.from_numpy(rois)

    def jax_run(fs):
        return jax.vjp(jax.jit(lambda fs: jax.vmap(
            lambda f, r, l: jrpn.pyramid_roi_align(f, r, l, STRIDES, 7))(
                fs, jnp.asarray(rois), jnp.asarray(lvl.numpy()))), fs)

    jbf = tuple(jnp.asarray(f.detach().float().numpy()).astype(jnp.bfloat16)
                for f in bf)
    jout, vjp = jax_run(jbf)
    jgrad = vjp(jnp.asarray(d_out))[0]
    _, vjp32 = jax_run(tuple(jnp.asarray(f.numpy()) for f in f32))
    jgrad32 = vjp32(jnp.asarray(d_out))[0]
    out = roi_align.pyramid_roi_align(bf, trois, lvl, STRIDES, 7)
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    jout = np.asarray(jout)
    assert np.abs(out.detach().numpy() - jout).max() <= 1e-5 * np.abs(
        jout).max()
    assert torch.equal(out, roi_align.pyramid_roi_align(f32, trois, lvl,
                                                        STRIDES, 7))
    out.backward(torch.from_numpy(d_out))
    want32 = roi_align.pyramid_roi_align_backward_plain(
        torch.from_numpy(d_out), [f.shape for f in feats], trois, lvl,
        STRIDES, 7)
    for g, w32, jg, jg32 in zip((f.grad for f in bf), want32, jgrad,
                                jgrad32):
        assert g.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16
        assert torch.equal(g, w32.to(torch.bfloat16))
        jg = np.asarray(jg.astype(jnp.float32))
        gap = np.abs(jg - np.asarray(jg32)).max()
        assert gap > 0
        assert np.abs(g.float().numpy() - jg).max() <= 2 * gap
