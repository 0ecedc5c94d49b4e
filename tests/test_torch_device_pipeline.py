"""The port's on-device preprocessing against the JAX package's, on the CPU
(``demf_tpu_torch/data/device_pipeline.py`` against
``demf_tpu/data/device_pipeline.py``), a counterpart of each test of
``tests/test_device_pipeline.py``.

The JAX package draws from ``jax.random.split(rng, 7)``, which the port
cannot reproduce: the tests replay those draws from the JAX keys
(``jax_draws``) and hand them to the port's ``preprocess(..., draws=)``.

* a pipeline with a host-only transform raises ``UnsupportedPipeline`` in
  both packages;
* the resize: within 5/57 normalized units of OpenCV's uint8 resize (its
  fixed-point taps, the JAX test's bound) and within 1e-4 of JAX's output,
  the pad exactly zero;
* ``RandomFlip`` mirrors the resized image and its 2D boxes, as in JAX;
* the 3D augmentation with a forced flip and pinned rotation and scale:
  boxes and meta against the port's host pipeline and JAX's output, every
  sampled point one of the transformed raw points;
* ``PointSample``: on the same draws the same points as JAX, without
  replacement where a cloud has enough points and with it where not;
* the height channel's 0.0099 quantile against ``np.percentile`` and
  JAX's, through the k-smallest route and the sort;
* the raw loader (``SUNRGBDDataset`` with ``LoadRaw``, ``collate_raw``)
  on the real-format fixture and the preprocess equal to JAX's;
* ``TrainStep(preprocess=)`` against ``make_train_step(preprocess=)`` on
  the same raw batch, weights and draws: the preprocessed batches equal,
  losses within 1e-4 relative (absolute below 1), the gradient norm and
  the gradients within 2e-3 of JAX's float64 gradients on that batch
  (float32 rounding of a 1.7e4 gradient).
"""
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.data import device_pipeline as jdp
from demf_tpu.engine import build_optimizer, create_train_state
from demf_tpu.engine import make_train_step
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.data import SUNRGBD_CLASSES, SUNRGBDDataset
from demf_tpu_torch.data import device_pipeline as dp
from demf_tpu_torch.data.pipeline import Compose
from demf_tpu_torch.engine import batch_to_device, state_dict_from_jax
from test_torch_votenet import (TINY, _perturbed, _rel, exact_cfg,
                                in_float64, vote_batch)

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'sunrgbd_mini')
ANN = os.path.join(FIXTURE, 'sunrgbd_infos_mini.pkl')
IMG_NORM = dict(mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)


def _pipeline(rot=(-0.523599, 0.523599), scale=(0.85, 1.15), flip3d=0.5,
              flip2d=0.0, num_points=2048, img_scale=(260, 200)):
    return [
        dict(type='LoadPointsFromFile', coord_type='DEPTH',
             shift_height=True, load_dim=6, use_dim=[0, 1, 2]),
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations3D'),
        dict(type='LoadAnnotations', with_bbox=True),
        dict(type='Resize', img_scale=img_scale, keep_ratio=True),
        dict(type='RandomFlip', flip_ratio=flip2d),
        dict(type='Normalize', **IMG_NORM),
        dict(type='Pad', size_divisor=32),
        dict(type='RandomFlip3D', sync_2d=False,
             flip_ratio_bev_horizontal=flip3d),
        dict(type='GlobalRotScaleTrans', rot_range=list(rot),
             scale_ratio_range=list(scale), shift_height=True),
        dict(type='PointSample', num_points=num_points),
        dict(type='DefaultFormatBundle3D', class_names=SUNRGBD_CLASSES),
        dict(type='Collect3D', keys=['img', 'gt_bboxes', 'gt_labels',
                                     'points', 'gt_bboxes_3d',
                                     'gt_labels_3d']),
    ]


def jax_draws(spec, rng, b, ncap):
    """The draws the JAX package's preprocess takes from ``rng`` for a raw
    batch of ``b`` scenes and a points cap of ``ncap``, by the port's
    names (``dp.DRAW_ORDER``)."""
    r_f2d, r_f3d, r_rot, r_scale, r_trans, r_keys, r_wr = \
        jax.random.split(rng, 7)
    t = torch.from_numpy
    out = dict(flip2d=t(np.asarray(jax.random.bernoulli(
        r_f2d, spec.flip2d_ratio, (b,)))), flip3d=t(np.asarray(
            jax.random.bernoulli(r_f3d, spec.flip3d_ratio, (b,)))))
    if spec.rot_range is not None:
        out['angle'] = t(np.asarray(jax.random.uniform(
            r_rot, (b,), minval=spec.rot_range[0],
            maxval=spec.rot_range[1])))
        out['scale'] = t(np.asarray(jax.random.uniform(
            r_scale, (b,), minval=spec.scale_range[0],
            maxval=spec.scale_range[1])))
        out['trans'] = t(np.asarray(jax.random.normal(r_trans, (b, 3)) *
                                    jnp.asarray(spec.trans_std,
                                                jnp.float32)))
    if spec.num_points is not None:
        out['keys'] = t(np.asarray(jax.random.uniform(r_keys, (b, ncap))))
        out['with_replacement'] = t(np.asarray(jax.random.uniform(
            r_wr, (b, spec.num_points))))
    return out


def both_preprocess(cfg, raw, rng, **spec_kw):
    """JAX's preprocess of ``raw`` (numpy) on ``rng`` and the port's on
    the same draws -> (JAX's batch as numpy, the port's)."""
    jspec = jdp.DevicePreprocessSpec(cfg, **spec_kw)
    want = jax.device_get(jax.jit(jdp.make_device_preprocess(jspec))(
        raw, rng))
    spec = dp.DevicePreprocessSpec(cfg, **spec_kw)
    lead = next(v for k, v in raw.items() if k.startswith('raw_'))
    ncap = raw['raw_points'].shape[1] if 'raw_points' in raw else 0
    got = dp.make_device_preprocess(spec)(
        batch_to_device(raw, 'cpu'), None,
        draws=jax_draws(spec, rng, lead.shape[0], ncap))
    return want, got


def _close(got, want, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=atol, rtol=0)


@pytest.mark.parametrize('insert', [
    dict(type='AutoAugment', policies=[]),
    dict(type='RandomCrop', crop_size=(64, 64))])
def test_unsupported_pipeline_raises(insert):
    cfg = _pipeline()
    cfg.insert(5, insert)
    with pytest.raises(jdp.UnsupportedPipeline):
        jdp.DevicePreprocessSpec(cfg)
    with pytest.raises(dp.UnsupportedPipeline):
        dp.DevicePreprocessSpec(cfg)
    resize = [dict(t, keep_ratio=False) if t['type'] == 'Resize' else t
              for t in _pipeline()]
    with pytest.raises(dp.UnsupportedPipeline, match='keep_ratio'):
        dp.DevicePreprocessSpec(resize)


def test_resize_matmul_matches_cv2_and_jax():
    import cv2
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (120, 160, 3), np.uint8)
    cfg = _pipeline(flip3d=0.0, rot=(0, 0), scale=(1, 1))
    raw = dict(raw_img=img[None],
               raw_img_shape=np.array([[120, 160]], np.int32))
    want, got = both_preprocess(cfg, raw, jax.random.PRNGKey(0),
                                raw_img_hw=(128, 176))
    out = got['img'][0].numpy()
    assert out.dtype == np.float32
    factor = min(260 / 160, 200 / 120)
    nw, nh = int(160 * factor + 0.5), int(120 * factor + 0.5)
    ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    ref = cv2.cvtColor(ref.astype(np.float32), cv2.COLOR_BGR2RGB)
    ref = (ref - np.asarray(IMG_NORM['mean'])) / np.asarray(IMG_NORM['std'])
    ch, cw = dp.DevicePreprocessSpec(cfg).canvas_hw
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:nh, :nw] = ref
    assert np.abs(out - canvas).max() < 5.0 / 57.0
    assert np.all(out[nh:] == 0) and np.all(out[:, nw:] == 0)
    _close(got['img'], want['img'], 1e-4)
    for key in ('img_shape', 'scale_factor', 'flip'):
        _close(got['img_meta'][key], want['img_meta'][key], 1e-6)


def test_flip2d_mirrors_resized_image_and_boxes():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (120, 160, 3), np.uint8)
    raw = dict(raw_img=img[None],
               raw_img_shape=np.array([[120, 160]], np.int32),
               gt_bboxes=np.array([[[10., 20., 50., 60.]]], np.float32),
               gt_labels=np.zeros((1, 1), np.int32),
               gt_bboxes_valid=np.ones((1, 1), bool))
    key = jax.random.PRNGKey(3)
    outs = {}
    for flip in (1.0, 0.0):
        cfg = _pipeline(flip2d=flip, flip3d=0.0, rot=(0, 0), scale=(1, 1))
        want, got = both_preprocess(cfg, raw, key, raw_img_hw=(128, 176))
        _close(got['img'], want['img'], 1e-4)
        _close(got['gt_bboxes'], want['gt_bboxes'], 1e-4)
        outs[flip] = got
    flipped, plain = outs[1.0], outs[0.0]
    nh, nw = flipped['img_meta']['img_shape'][0].tolist()
    assert bool(flipped['img_meta']['flip'][0])
    np.testing.assert_allclose(flipped['img'][0, :nh, :nw].numpy(),
                               plain['img'][0, :nh, :nw].flip(1).numpy(),
                               atol=2e-2)
    bf, bn = flipped['gt_bboxes'][0, 0], plain['gt_bboxes'][0, 0]
    np.testing.assert_allclose(bf[[0, 2]], nw - bn[[2, 0]], atol=1e-4)
    np.testing.assert_allclose(bf[[1, 3]], bn[[1, 3]], atol=1e-4)


def _fixture_raw(cfg, **kw):
    host_load, collate, _, spec = dp.build_device_pipeline(cfg, **kw)
    ds = SUNRGBDDataset(FIXTURE, ANN, pipeline=[host_load],
                        test_mode=False, filter_empty_gt=True)
    return collate([ds[i] for i in range(len(ds))]), spec


def test_deterministic_3d_aug_matches_host_and_jax():
    """Pinned rotation and scale, forced flip: boxes and meta as the
    port's host pipeline makes them and as JAX's device pipeline does;
    every sampled point one of the raw cloud's, transformed."""
    ang, sc = 0.3, 1.1
    cfg = _pipeline(rot=(ang, ang), scale=(sc, sc), flip3d=1.0)
    raw, spec = _fixture_raw(cfg)
    want, out = both_preprocess(cfg, raw, jax.random.PRNGKey(0))
    host = Compose(cfg[:-1])
    ds = SUNRGBDDataset(FIXTURE, ANN, pipeline=None, test_mode=False,
                        filter_empty_gt=True)
    for i in range(len(ds)):
        h = host(ds[i])
        g = int(raw['gt_valid'][i].sum())
        np.testing.assert_allclose(out['gt_bboxes_3d'][i, :g].numpy(),
                                   h['gt_bboxes_3d'][:g], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(out['img_meta']['pcd_rotation'][i],
                                   h['pcd_rotation'], atol=1e-5)
        assert bool(out['img_meta']['pcd_horizontal_flip'][i])
        assert float(out['img_meta']['pcd_scale_factor'][i]) == \
            pytest.approx(sc)
        raw_pts = np.fromfile(h['pts_filename'],
                              np.float32).reshape(-1, 6)[:, :3]
        height = raw_pts[:, 2] - np.percentile(raw_pts[:, 2], 0.99)
        pts = np.concatenate([raw_pts, height[:, None]], 1)
        pts[:, 0] = -pts[:, 0]
        c, s = np.cos(ang), np.sin(ang)
        mat = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        pts[:, :3] = pts[:, :3] @ mat * sc
        pts[:, 3] = pts[:, 3] * sc
        dev_pts = out['points'][i].numpy()
        d = np.abs(dev_pts[:, None, :] - pts[None, :, :]).sum(-1).min(1)
        assert d.max() < 1e-3
    _close(out['gt_bboxes_3d'], want['gt_bboxes_3d'], 1e-5)
    _close(out['points'], want['points'], 1e-5)


@pytest.mark.parametrize('counts', [(400, 60), (512, 511)])
def test_point_sample_replacement_semantics(counts):
    """On JAX's draws the port samples the same points: without
    replacement where a cloud has at least ``num_points``, with it (only
    from its own points) where not."""
    cfg = [dict(type='LoadPointsFromFile', coord_type='DEPTH',
                load_dim=6, use_dim=[0, 1, 2]),
           dict(type='PointSample', num_points=128),
           dict(type='Collect3D', keys=['points'])]
    pts = np.zeros((2, 512, 3), np.float32)
    pts[:, :, 0] = np.arange(512)[None]
    raw = dict(raw_points=pts, raw_points_count=np.array(counts, np.int32))
    want, got = both_preprocess(cfg, raw, jax.random.PRNGKey(7),
                                points_cap=512)
    np.testing.assert_array_equal(got['points'].numpy(), want['points'])
    for i, n in enumerate(counts):
        ids = got['points'][i, :, 0].long()
        assert int(ids.max()) < n
        if n >= 128:
            assert len(ids.unique()) == 128
    gen = dp.make_device_preprocess(dp.DevicePreprocessSpec(
        cfg, points_cap=512))(batch_to_device(raw, 'cpu'),
                              torch.Generator().manual_seed(0))
    assert len(gen['points'][0, :, 0].unique()) == 128


@pytest.mark.parametrize('n', [256, 120000])
def test_shift_height_matches_host_percentile_and_jax(n):
    """The masked 0.0099 quantile by the k smallest (n 256: rank < 1024)
    and by the sort (n 120,000) against ``np.percentile`` and JAX's."""
    rng = np.random.RandomState(3)
    z = rng.randn(2, n).astype(np.float32)
    cnt = np.array([n, n // 2], np.int32)
    got = dp._masked_quantile_z(torch.from_numpy(z), torch.from_numpy(cnt),
                                0.99 / 100.0)
    want = jdp._masked_quantile_z(jnp, jnp.asarray(z), jnp.asarray(cnt),
                                  0.99 / 100.0)
    for i in range(2):
        assert got[i].item() == pytest.approx(
            np.percentile(z[i, :cnt[i]], 0.99), abs=1e-5)
    _close(got, want, 1e-6)


def test_e2e_fixture_raw_loader_and_preprocess_match_jax():
    """The raw loader on the real-format fixture (a dataset given
    ``LoadRaw``, the loader given ``collate_raw``) equals JAX's collate,
    and the preprocess of the batch equals JAX's on the same draws."""
    from demf_tpu.data.sunrgbd import SUNRGBDDataset as JaxDataset
    from demf_tpu_torch.data import build_dataloader
    cfg = _pipeline()
    host_load, collate, _, spec = dp.build_device_pipeline(cfg)
    ds = SUNRGBDDataset(FIXTURE, ANN, pipeline=[host_load],
                        test_mode=False, filter_empty_gt=True)
    loader = build_dataloader(ds, samples_per_gpu=len(ds),
                              workers_per_gpu=2, shuffle=False,
                              collate_fn=collate)
    raw = next(iter(loader))
    jload, jcollate, _, _ = jdp.build_device_pipeline(cfg)
    jds = JaxDataset(FIXTURE, ANN, pipeline=[jload], test_mode=False,
                     filter_empty_gt=True)
    jraw = jcollate([jds[i] for i in range(len(jds))])
    assert set(raw) == set(jraw)
    for key, w in jraw.items():
        if key == 'img_meta':
            assert set(raw[key]) == set(w)
            for k in w:
                np.testing.assert_array_equal(raw[key][k], w[k])
        else:
            np.testing.assert_array_equal(raw[key], w)
    assert raw['raw_img'].dtype == np.uint8
    want, out = both_preprocess(cfg, raw, jax.random.PRNGKey(0))
    ch, cw = spec.canvas_hw
    assert tuple(out['points'].shape) == (2, 2048, 4)
    assert tuple(out['img'].shape) == (2, ch, cw, 3)
    assert set(out['img_meta']) == set(want['img_meta'])
    _close(out['points'], want['points'], 1e-5)
    _close(out['img'], want['img'], 1e-4)
    for key in ('gt_bboxes_3d', 'gt_bboxes'):
        _close(out[key], want[key], 1e-4)
    for key, w in want['img_meta'].items():
        _close(out['img_meta'][key], w, 1e-5)


# the step's points-only pipeline; its rotation is pinned at 0 because
# XLA's and torch's cos / sin of one angle differ by an ulp, which moves
# ball-query picks downstream (the rotation is held at 1e-5 above)
DEVPIPE_CFG = [
    dict(type='LoadPointsFromFile', coord_type='DEPTH', shift_height=True,
         load_dim=6, use_dim=[0, 1, 2]),
    dict(type='LoadAnnotations3D'),
    dict(type='RandomFlip3D', sync_2d=False, flip_ratio_bev_horizontal=0.5),
    dict(type='GlobalRotScaleTrans', rot_range=[0.0, 0.0],
         scale_ratio_range=[0.85, 1.15], shift_height=True),
    dict(type='PointSample', num_points=1024),
    dict(type='Collect3D', keys=['points', 'gt_bboxes_3d', 'gt_labels_3d']),
]


def test_train_step_with_preprocess_matches_jax():
    """The tiny VoteNet's step on a raw batch (2 clouds of 1,500 and 2,048
    points in a cap of 2,048, sampled to 1,024 without and with
    replacement, flipped and scaled at random):
    ``TrainStep(preprocess=)`` of ``zoo.build_trainer`` on JAX's draws
    against ``make_train_step(preprocess=)``: each loss within 1e-4
    relative (absolute below 1: the direction residual's 0.025 comes out
    1.4e-5 apart, float32 rounding through train-mode BatchNorm), JAX's
    step's gradient norm that of ``jax.grad`` of the same preprocess and
    loss within 1e-6; the port's gradient norm (2.4e4 here) within 2e-3
    and each gradient (after the same clip) within 2e-3 of the largest
    gradient, both against ``jax.grad`` of the loss on the same
    preprocessed batch in float64 (``jax.enable_x64``, float64 weights,
    statistics and batch).  Against JAX's float32 gradients the port sat
    at 0.76 and 0.53 of those bounds on a host with AVX-512 (the norm
    1.5e-3 apart; SA0's first layer, the largest gradient, 1.7e4 before
    the clip on these clouds of up to 6 m, 1.04e-3): XLA's float32 code
    for this backward strays there, as ``tests/test_torch_votenet.py``
    says of the same model's step.  The preprocessed batches are equal
    bit for bit, so what is left is the port's own float32 rounding
    through train-mode BatchNorm."""
    model_cfg = exact_cfg(TINY.model)
    base = vote_batch(2048)
    raw = dict(raw_points=base['points'][..., :3].copy(),
               raw_points_count=np.array([1500, 2048], np.int32),
               gt_bboxes_3d=base['gt_bboxes_3d'],
               gt_labels_3d=base['gt_labels_3d'], gt_valid=base['gt_valid'],
               img_meta={})
    spec = jdp.DevicePreprocessSpec(DEVPIPE_CFG, points_cap=2048)
    device_fn = jdp.make_device_preprocess(spec)
    jmodel = build_from_cfg(model_cfg, JAX_DETECTORS)
    jraw = jax.tree_util.tree_map(jnp.asarray, raw)
    params, stats = _perturbed(jmodel, dict(points=jnp.zeros((2, 1024, 4))))
    variables = dict(params=unflatten_params(params),
                     batch_stats=unflatten_params(stats))
    tx = build_optimizer(dict(TINY.optimizer), variables['params'])
    state = create_train_state(jmodel, tx, variables)
    rng = jax.random.PRNGKey(1)
    step = make_train_step(jmodel, tx, preprocess=device_fn, donate=False)
    _, metrics = jax.device_get(step(state, jraw, rng))

    def loss_fn(p):
        batch = jax.lax.stop_gradient(device_fn(jraw, jax.random.fold_in(
            rng, 2)))
        results, _ = jmodel.apply(
            {'params': p, 'batch_stats': variables['batch_stats']}, batch,
            train=True, mutable=['batch_stats'],
            rngs={'sample': rng, 'dropout': jax.random.fold_in(rng, 1)})
        return sum(jmodel.loss(results, batch).values())

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(variables['params']))
    assert _rel(metrics['grad_norm'], float(optax.global_norm(grads))) < 1e-6

    def loss64(p, s, batch):
        results, _ = jmodel.apply(
            {'params': p, 'batch_stats': s}, batch, train=True,
            mutable=['batch_stats'],
            rngs={'sample': rng, 'dropout': jax.random.fold_in(rng, 1)})
        return sum(jmodel.loss(results, batch).values())

    batch32 = jax.device_get(device_fn(jraw, jax.random.fold_in(rng, 2)))
    with jax.enable_x64(True):
        grads = jax.device_get(jax.jit(jax.grad(loss64))(*in_float64((
            variables['params'], variables['batch_stats'], batch32))))
    norm = float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                             for g in jax.tree_util.tree_leaves(grads))))

    port_spec = dp.DevicePreprocessSpec(DEVPIPE_CFG, points_cap=2048)
    preprocess = dp.make_device_preprocess(port_spec)
    draws = jax_draws(port_spec, jax.random.fold_in(rng, 2), 2, 2048)
    model, _, train_step = zoo.build_trainer(
        dict(model=model_cfg, optimizer=TINY.optimizer,
             optimizer_config=TINY.optimizer_config,
             lr_config=TINY.lr_config), 'cpu',
        preprocess=lambda b, g: preprocess(b, g, draws=draws))
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    got = train_step(batch_to_device(raw, 'cpu'),
                     torch.Generator().manual_seed(0))
    assert set(got) == set(metrics)
    for key, w in metrics.items():
        if key != 'grad_norm':
            assert float(w) > 0 or key.startswith('dir'), key
            assert abs(got[key].item() - float(w)) <= 1e-4 * max(
                abs(float(w)), 1.0), key
    assert _rel(got['grad_norm'], norm) < 2e-3
    max_norm = TINY.optimizer_config['grad_clip']['max_norm']
    scale = min(1.0, max_norm / norm)
    want = state_dict_from_jax(flatten_params(grads), {})
    params_t = dict(model.named_parameters())
    largest = max(np.abs(w.numpy()).max() for w in want.values()) * scale
    compared = 0
    for name, p in params_t.items():
        w, g = want[name].numpy() * scale, p.grad.numpy()
        if np.abs(w).max() < 1e-6 * largest:     # a bias before a BN
            assert np.abs(g).max() < 1e-6 * largest, name
            continue
        assert np.abs(g - w).max() <= 2e-3 * largest, name
        compared += 1
    assert compared > 30
