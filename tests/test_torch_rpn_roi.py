"""The Faster R-CNN branch of the port's ImVoteNet against the JAX
package's, on the CPU: anchors equal; the delta coder within 1e-6; the
pyramid RoIAlign and the single-level ``roi_align`` within 1e-5 of the
largest output, with RoIs across the borders (the clamp) and on every
level; the level rule equal; the caffe ResNet-50 + FPN at a 64x96 image
within 1e-4 of each level's largest; the RPN head and its proposals, and the
RoI head and its detections, at small widths on the same weights
(``state_dict_from_jax``): outputs within 1e-5 of their largest, valid
masks equal and the valid rows within 1e-5 of the image's size."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX modules)
from demf_tpu.engine.torch_port import flatten_params
from demf_tpu.models import rpn_roi as jrpn
from demf_tpu.ops.roi_align import roi_align as jax_roi_align
from demf_tpu.utils.registry import BACKBONES, HEADS, NECKS, build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import state_dict_from_jax
from demf_tpu_torch.models import rpn_roi
from demf_tpu_torch.ops import roi_align
from demf_tpu_torch.registry import BACKBONES as T_BACKBONES
from demf_tpu_torch.registry import HEADS as T_HEADS
from demf_tpu_torch.registry import NECKS as T_NECKS

TINY = zoo.tiny_imvotenet_model_cfg()
STRIDES = (4, 8, 16, 32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def port_module(registry, cfg, variables, prefix):
    """The port's module of ``cfg`` with the flax ``variables`` of the same
    module, carried by ``state_dict_from_jax`` under ``prefix``."""
    module = build_from_cfg(cfg, registry)
    params = {f'{prefix}/{k}': np.asarray(v) for k, v in
              flatten_params(variables['params']).items()}
    stats = {f'{prefix}/{k}': np.asarray(v) for k, v in
             flatten_params(variables.get('batch_stats', {})).items()}
    sd = {k[len(prefix) + 1:]: v for k, v in
          state_dict_from_jax(params, stats).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_grid_anchors_equal_jax():
    for hw, stride in (((4, 6), 8), ((19, 26), 32), ((10, 13), 64)):
        want = np.asarray(jrpn.grid_anchors(hw, stride, [8], [0.5, 1., 2.]))
        got = rpn_roi.grid_anchors(hw, stride, [8], [0.5, 1., 2.])
        np.testing.assert_array_equal(got.numpy(), want)


def test_delta_coder_matches_jax():
    rng = np.random.RandomState(0)
    anchors = np.abs(rng.rand(2, 50, 4)).astype(np.float32) * 50
    anchors[..., 2:] += anchors[..., :2] + 5
    boxes = (anchors + rng.randn(2, 50, 4) * 4).astype(np.float32)
    deltas = (rng.randn(2, 50, 4) * 2).astype(np.float32)   # some clipped
    stds = (0.1, 0.1, 0.2, 0.2)
    shape = np.array([[60, 90], [40, 70]], np.float32)
    want = np.asarray(jax.vmap(lambda a, d, s: jrpn.delta2bbox(
        a, d, stds=stds, max_shape=(s[0], s[1])))(
            jnp.asarray(anchors), jnp.asarray(deltas), jnp.asarray(shape)))
    t = torch.from_numpy
    got = rpn_roi.delta2bbox(t(anchors), t(deltas), stds=stds, max_shape=(
        t(shape[:, :1]), t(shape[:, 1:])))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    want = np.asarray(jrpn.bbox2delta(jnp.asarray(anchors),
                                      jnp.asarray(boxes), stds=stds))
    got = rpn_roi.bbox2delta(t(anchors), t(boxes), stds=stds)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def pyramid_case(b=2, r=60, c=8, seed=0):
    """Four NHWC levels of a 64x96 image and RoIs of every size, some
    across the image's borders and some beyond them."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(b, 64 // s, 96 // s, c).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(-20, 100, (b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(1000), (b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :4] = [[-8, -8, 10, 12], [80, 50, 110, 80], [0, 0, 96, 64],
                   [95, 63, 96, 64]]
    return feats, rois


def test_level_rule_equals_jax():
    _, rois = pyramid_case(r=400)
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    scale = jnp.sqrt(jnp.clip(jnp.asarray(w * h), 1e-6, None))
    want = np.asarray(jnp.clip(jnp.floor(jnp.log2(scale / 56.0 + 1e-6)), 0,
                               3).astype(jnp.int32))
    got = roi_align.roi_levels(torch.from_numpy(rois), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}      # every level is used


def test_pyramid_roi_align_matches_jax():
    feats, rois = pyramid_case()
    lvl = roi_align.roi_levels(torch.from_numpy(rois), 4)
    lvl[:, ::4] = torch.arange(4).repeat(lvl.shape[1] // 4 + 1)[
        :lvl[:, ::4].shape[1]]     # every level, RoIs of any size on it
    want = np.asarray(jax.vmap(lambda f, r, l: jrpn.pyramid_roi_align(
        f, r, l, STRIDES, 7))(tuple(jnp.asarray(f) for f in feats),
                              jnp.asarray(rois), jnp.asarray(lvl.numpy())))
    got = roi_align.pyramid_roi_align(
        tuple(torch.from_numpy(f) for f in feats), torch.from_numpy(rois),
        lvl, STRIDES, 7)
    assert got.shape == (2, 60, 7, 7, 8)
    assert _rel(got, want) < 1e-5
    # the plain version's chunks do not change the result
    saved = roi_align.PLAIN_CHUNK
    try:
        roi_align.PLAIN_CHUNK = 7 * 7 * 4 * 8 * 2 * 3
        again = roi_align.pyramid_roi_align_plain(
            tuple(torch.from_numpy(f) for f in feats),
            torch.from_numpy(rois), lvl, STRIDES, 7)
    finally:
        roi_align.PLAIN_CHUNK = saved
    assert torch.equal(again, got)


# the FPN's four pooled levels at the path's 608x832 image
PATH_SIZES = ((152, 208), (76, 104), (38, 52), (19, 26))


@pytest.mark.parametrize('samples', [2, 3])
def test_k11_sample_table_equals_the_plain_corners(samples):
    """K11's staged sample table (``sample_table``) equals, bit for bit,
    the corners and weights of ``_sample_corners`` with the plain
    version's clamps, on the path's four levels and strides, for RoIs of
    every size and place (inside, across the borders, beyond them)."""
    rng = np.random.RandomState(samples)
    xy = rng.uniform(-60, 900, (2, 300, 2))
    wh = np.exp(rng.uniform(np.log(1), np.log(2000), (2, 300, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))
    lvl = roi_align.roi_levels(rois, 4)
    lvl[:, ::3] = torch.from_numpy(rng.randint(0, 4, lvl[:, ::3].shape)).int()
    table = roi_align.sample_table(rois, lvl, STRIDES, PATH_SIZES, 7, samples)
    boxes = rois * torch.tensor([1.0 / s for s in STRIDES])[lvl.long()][
        ..., None]
    x0, wx, y0, wy = roi_align._sample_corners(
        boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3], 7,
        samples)
    for axis, v0, far, dim in (('y', y0, wy, 0), ('x', x0, wx, 1)):
        top = torch.tensor([hw[dim] for hw in PATH_SIZES])[lvl.long()][
            ..., None] - 1
        near_i, far_i, far_w, near_w = table[axis]
        assert torch.equal(near_i, torch.minimum(v0.long().clamp_min(0), top))
        assert torch.equal(far_i, torch.minimum((v0 + 1).long().clamp_min(0),
                                                top))
        assert torch.equal(far_w, far) and torch.equal(near_w, 1 - far)
        assert (near_i == 0).any() and (far_i == top).any()   # clamped
    # the plain version the kernel must equal is unchanged: the JAX
    # package's pyramid RoIAlign
    feats = tuple(torch.randn((2, h, w, 4), generator=torch.Generator(
        ).manual_seed(1)) for h, w in PATH_SIZES)
    want = np.asarray(jax.vmap(lambda f, r, l: jrpn.pyramid_roi_align(
        f, r, l, STRIDES, 7, samples))(
            tuple(jnp.asarray(f.numpy()) for f in feats),
            jnp.asarray(rois.numpy()), jnp.asarray(lvl.numpy())))
    got = roi_align.pyramid_roi_align_plain(feats, rois, lvl, STRIDES, 7,
                                            samples)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize('scale,samples', [(0.25, 2), (0.125, 3)])
def test_roi_align_matches_jax(scale, samples):
    feats, rois = pyramid_case(b=1, r=40, seed=1)
    f = feats[0][0] if scale == 0.25 else feats[1][0]
    want = np.asarray(jax_roi_align(jnp.asarray(f), jnp.asarray(rois[0]), 5,
                                    scale, samples))
    got = roi_align.roi_align(torch.from_numpy(f), torch.from_numpy(rois[0]),
                              5, scale, samples)
    assert _rel(got, want) < 1e-5


def test_pyramid_and_single_level_share_the_sample_rule():
    feats, rois = pyramid_case(b=1, r=20, seed=2)
    lvl = torch.full((1, 20), 2, dtype=torch.int32)
    pyr = roi_align.pyramid_roi_align(
        tuple(torch.from_numpy(f) for f in feats), torch.from_numpy(rois),
        lvl, STRIDES, 7)
    one = roi_align.roi_align(torch.from_numpy(feats[2][0]),
                              torch.from_numpy(rois[0]), 7, 1 / 16)
    assert torch.equal(pyr[0], one)


@pytest.fixture(scope='module')
def backbone_pair():
    """The caffe ResNet-50 + FPN of the tiny ImVoteNet at a 64x96 image,
    JAX initialized and run once."""
    jb = build_from_cfg(dict(TINY['img_backbone']), BACKBONES)
    jn = build_from_cfg(dict(TINY['img_neck']), NECKS)
    img = np.random.RandomState(3).rand(2, 64, 96, 3).astype(np.float32)

    @jax.jit
    def run(rng, x):
        vb = jb.init(rng, x)
        feats = jb.apply(vb, x)
        vn = jn.init(rng, feats)
        return vb, vn, feats, jn.apply(vn, feats)

    vb, vn, feats, outs = jax.device_get(run(jax.random.PRNGKey(0), img))
    return dict(vb=vb, vn=vn, img=img, feats=feats, outs=outs)


def test_caffe_resnet50_and_fpn_match_jax(backbone_pair):
    p = backbone_pair
    assert TINY['img_backbone']['style'] == 'caffe'
    backbone = port_module(T_BACKBONES, dict(TINY['img_backbone']), p['vb'],
                           'img_backbone')
    neck = port_module(T_NECKS, dict(TINY['img_neck']), p['vn'], 'img_neck')
    with torch.no_grad():
        feats = backbone(torch.from_numpy(p['img']))
        outs = neck(feats)
    assert len(feats) == 4 and len(outs) == 5
    for got, want in zip(feats, p['feats']):
        assert _rel(got, want) < 1e-4
    for got, want in zip(outs, p['outs']):
        assert _rel(got, want) < 1e-4
    assert tuple(outs[-1].shape) == (2, 1, 2, 16)       # max-pool 2x3 -> 1x2
    # the caffe style puts a stage's stride on conv1, the pytorch on conv2
    assert backbone.layer2[0].conv1.stride == (2, 2)
    assert backbone.layer2[0].conv2.stride == (1, 1)


def rpn_case(seed=4):
    """A 128x192 image's five FPN levels of 16 channels."""
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 128 // s, 192 // s, 16).astype(np.float32)
            for s in (4, 8, 16, 32, 64)]


def check_padded(got, want, valid, scale):
    np.testing.assert_array_equal(np.asarray(valid[1]),
                                  np.asarray(valid[0]))
    v = np.asarray(valid[0])
    assert v.any()
    assert np.abs(np.asarray(got)[v] - np.asarray(want)[v]).max() <= \
        1e-5 * scale


def test_rpn_head_and_proposals_match_jax():
    cfg = dict(TINY['img_rpn_head'])
    proposal_cfg = dict(TINY['test_cfg']['img_rpn'], nms_pre=150,
                        max_per_img=64)
    jhead = build_from_cfg(dict(cfg), HEADS)
    feats = rpn_case()
    img_shape = np.array([[128, 192], [120, 180]], np.int32)

    @jax.jit
    def run(rng, f, shape):
        v = jhead.init(rng, f)
        outs = jhead.apply(v, f)
        return v, outs, jhead.get_proposals(outs, shape, proposal_cfg)

    v, outs, (props, scores, valid) = jax.device_get(run(
        jax.random.PRNGKey(1), tuple(jnp.asarray(f) for f in feats),
        jnp.asarray(img_shape)))
    head = port_module(T_HEADS, cfg, v, 'img_rpn_head')
    with torch.no_grad():
        touts = head(tuple(torch.from_numpy(f) for f in feats))
    for (gc, gr), (wc, wr) in zip(touts, outs):
        assert _rel(gc, wc) < 1e-5 and _rel(gr, wr) < 1e-5
    # the same head outputs on both sides: proposals, scores, validity
    got = head.get_proposals(
        [tuple(torch.from_numpy(np.asarray(x)) for x in o) for o in outs],
        torch.from_numpy(img_shape), proposal_cfg)
    assert tuple(got[0].shape) == (2, 64, 4)
    check_padded(got[0], props, (got[2], valid), 192)
    check_padded(got[1], scores, (got[2], valid), 1)
    # the NMS suppressed some: fewer kept than the 150 + 150 + 72 + 18 + 6
    # candidates, and the level groups kept boxes that overlap
    assert 0 < int(valid.sum()) <= 128


def test_roi_head_and_detections_match_jax():
    cfg = dict(TINY['img_roi_head'])
    test_cfg = dict(TINY['test_cfg']['img_rcnn'], score_thr=0.05,
                    max_per_img=40)
    jhead = build_from_cfg(dict(cfg, test_cfg=test_cfg), HEADS)
    rng = np.random.RandomState(6)
    feats = rpn_case(seed=7)[:4]
    xy = rng.uniform(0, 150, (2, 48, 2))
    wh = rng.uniform(8, 120, (2, 48, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    pvalid = rng.rand(2, 48) < 0.9
    img_shape = np.array([[128, 192], [120, 180]], np.int32)

    @jax.jit
    def run(key, f, p, pv, shape):
        v = jhead.init(key, f, p, pv)
        cls, deltas = jhead.apply(v, f, p, pv)
        return v, cls, deltas, jhead.get_bboxes(cls, deltas, p, pv, shape)

    v, cls, deltas, det = jax.device_get(run(
        jax.random.PRNGKey(2), tuple(jnp.asarray(f) for f in feats),
        jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(img_shape)))
    head = port_module(T_HEADS, dict(cfg, test_cfg=test_cfg), v,
                       'img_roi_head')
    t = torch.from_numpy
    with torch.no_grad():
        tcls, tdeltas = head(tuple(t(f) for f in feats), t(props))
    assert _rel(tcls, cls) < 1e-5 and _rel(tdeltas, deltas) < 1e-5
    # the same head outputs on both sides: detections and validity
    got = head.get_bboxes(t(np.asarray(cls)), t(np.asarray(deltas)),
                          t(props), t(pvalid), t(img_shape))
    assert tuple(got['bboxes'].shape) == (2, 40, 5)
    check_padded(got['bboxes'], det['bboxes'], (got['valid'], det['valid']),
                 192)
    check_padded(got['labels'], det['labels'], (got['valid'], det['valid']),
                 0)
    assert int(det['valid'].sum()) > 10
