"""The port's ops against the JAX package's, on the same numpy inputs.

FPS, ball query and MSDA run their plain PyTorch versions here (CPU
tensors); their CUDA kernels are held against the same plain versions by
``test_torch_kernels.py`` and ``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demf_tpu import ops as jops
from demf_tpu.core import boxes as jboxes
from demf_tpu.core import coders as jcoders
from demf_tpu.core import transforms as jtransforms
from demf_tpu.ops.pallas.fps import furthest_point_sample_pallas
from demf_tpu.ops.sampling import _furthest_point_sample_xla
from demf_tpu_torch import ops
from demf_tpu_torch.core import boxes, coders, transforms
from demf_tpu_torch.ops import grouping, msda, sampling
from test_torch_kernels import unambiguous_centers


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize('n,k', [(300, 32), (1000, 100)])
def test_fps_plain_matches_xla_and_pallas(n, k):
    xyz = np.random.RandomState(n).randn(2, n, 3).astype(np.float32)
    got = ops.furthest_point_sample(_t(xyz), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), k)))
    np.testing.assert_array_equal(
        got, np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), k,
                                                     True)))


@pytest.mark.parametrize('radius,k', [(0.2, 8), (0.5, 16)])
def test_ball_query_plain_matches_jax_exact(radius, k):
    rng = np.random.RandomState(1)
    points = rng.rand(2, 400, 3).astype(np.float32)
    centers = points[:, :64]
    got = ops.ball_query(radius, k, _t(points), _t(centers)).numpy()
    want = np.asarray(jops.ball_query(radius, k, jnp.asarray(points),
                                      jnp.asarray(centers), exact=True))
    compared = 0
    for b in range(2):
        ok = unambiguous_centers(points[b], centers[b], radius, k)
        compared += ok.sum()
        for i in np.where(ok)[0]:
            assert set(got[b, i]) == set(want[b, i]), (b, i)
    assert compared >= 0.9 * 2 * 64


def test_ball_query_padding_and_empty():
    points = np.full((1, 16, 3), 10.0, np.float32)
    points[0, 3] = 0.01
    centers = np.zeros((1, 2, 3), np.float32)
    centers[0, 1] = -5.0
    got = ops.ball_query(0.5, 4, _t(points), _t(centers)).numpy()
    np.testing.assert_array_equal(got, [[[3, 3, 3, 3], [0, 0, 0, 0]]])


def test_grouping_matches_jax():
    rng = np.random.RandomState(2)
    points = rng.rand(2, 300, 3).astype(np.float32)
    centers = points[:, :40]
    feats = rng.randn(2, 5, 300).astype(np.float32)
    got, idx = ops.query_and_group(_t(points), _t(centers), _t(feats), 0.3,
                                   8, normalize_xyz=True)
    jidx = jnp.asarray(idx.numpy().astype(np.int32))
    rel = jops.group_points(jnp.swapaxes(jnp.asarray(points), 1, 2), jidx) - \
        jnp.swapaxes(jnp.asarray(centers), 1, 2)[..., None]
    want = jnp.concatenate(
        [rel / 0.3, jops.group_points(jnp.asarray(feats), jidx)], 1)
    assert _rel(got, want) < 1e-6
    assert _rel(ops.gather_points(_t(feats), idx[..., 0]),
                jops.gather_points(jnp.asarray(feats), jidx[..., 0])) == 0


def test_three_nn_interpolate_matches_jax():
    rng = np.random.RandomState(3)
    unknown = rng.randn(2, 50, 3).astype(np.float32)
    known = rng.randn(2, 12, 3).astype(np.float32)
    feats = rng.randn(2, 12, 8).astype(np.float32)
    got = ops.three_nn_interpolate(_t(unknown), _t(known), _t(feats))
    want = jops.three_nn_interpolate(jnp.asarray(unknown), jnp.asarray(known),
                                     jnp.asarray(feats))
    assert _rel(got, want) < 1e-5


# small-q: q * L * P * 8 < sum_HW takes _make_small_q_msda; large-q
# takes _make_msda
@pytest.mark.parametrize('q,p', [(1, 2), (40, 4)])
def test_msda_plain_matches_jax(q, p):
    shapes = ((8, 12), (4, 6), (2, 3), (1, 2))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(q)
    value = rng.randn(2, s, 2, 4).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (2, q, 2, 4, p, 2)).astype(np.float32)
    aw = rng.rand(2, q, 2, 4, p).astype(np.float32)
    aw /= aw.sum((-1, -2), keepdims=True)
    got = ops.multi_scale_deformable_attention(_t(value), shapes, _t(locs),
                                               _t(aw))
    want = jops.multi_scale_deformable_attention(
        jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(aw),
        gather_dtype=jnp.float32)
    assert _rel(got, want) < 1e-5


def test_aligned_3d_nms_matches_jax():
    rng = np.random.RandomState(5)
    lo = rng.rand(2, 64, 3).astype(np.float32) * 2
    bxs = np.concatenate([lo, lo + rng.rand(2, 64, 3).astype(np.float32) +
                          0.2], -1)
    scores = rng.rand(2, 64).astype(np.float32)
    classes = rng.randint(0, 3, (2, 64))
    valid = rng.rand(2, 64) < 0.9
    got = ops.aligned_3d_nms(_t(bxs), _t(scores), _t(classes), 0.25,
                             _t(valid)).numpy()
    for b in range(2):
        want = np.asarray(jops.aligned_3d_nms(
            jnp.asarray(bxs[b]), jnp.asarray(scores[b]),
            jnp.asarray(classes[b]), 0.25, jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got[b], want)


def _random_boxes(rng, n):
    bx = np.zeros((n, 7), np.float32)
    bx[:, :3] = rng.randn(n, 3)
    bx[:, 3:6] = rng.rand(n, 3) + 0.2
    bx[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return bx


def test_boxes_match_jax():
    rng = np.random.RandomState(6)
    bx = _random_boxes(rng, 20)
    pts = rng.randn(300, 3).astype(np.float32)
    assert _rel(boxes.box_corners(_t(bx)), jboxes.box_corners(
        jnp.asarray(bx))) < 1e-6
    assert _rel(boxes.corners_minmax(_t(bx)), jboxes.corners_minmax(
        jnp.asarray(bx))) < 1e-6
    np.testing.assert_array_equal(
        boxes.points_in_boxes(_t(pts), _t(bx)).numpy(),
        np.asarray(jboxes.points_in_boxes(jnp.asarray(pts), jnp.asarray(bx))))
    mm = np.asarray(jboxes.corners_minmax(jnp.asarray(bx)))
    assert _rel(boxes.aligned_box_iou_3d(_t(mm), _t(mm[:7])),
                jboxes.aligned_box_iou_3d(jnp.asarray(mm),
                                          jnp.asarray(mm[:7]))) < 1e-6
    val = rng.uniform(-7, 7, 50).astype(np.float32)
    assert _rel(boxes.limit_period(_t(val)),
                jboxes.limit_period(jnp.asarray(val))) < 1e-6
    cls = rng.randint(0, 12, 50)
    assert _rel(boxes.class2angle(_t(cls), _t(val), 12),
                jboxes.class2angle(jnp.asarray(cls), jnp.asarray(val),
                                   12)) < 1e-6


@pytest.mark.parametrize('name', ['ClassAgnosticBBoxCoder',
                                  'DeMFClassAgnosticBBoxCoder'])
def test_coders_match_jax(name):
    rng = np.random.RandomState(7)
    cls_pred = rng.randn(2, 12, 30).astype(np.float32)
    reg_pred = rng.randn(2, 30, 30).astype(np.float32)
    ref = rng.randn(2, 30, 3).astype(np.float32)
    port = getattr(coders, name)(num_dir_bins=12)
    ref_coder = getattr(jcoders, name)(num_dir_bins=12)
    got = port.split_pred(_t(cls_pred), _t(reg_pred), _t(ref))
    want = ref_coder.split_pred(jnp.asarray(cls_pred), jnp.asarray(reg_pred),
                                jnp.asarray(ref))
    assert set(got) == set(want)
    for k in got:
        assert _rel(got[k], want[k]) < 1e-6, k
    assert _rel(port.decode(got), ref_coder.decode(want)) < 1e-5


def test_project_points_to_image_matches_jax():
    rng = np.random.RandomState(8)
    pts = (rng.randn(2, 40, 3) + [0, 3, 0]).astype(np.float32)
    theta = rng.uniform(-0.5, 0.5, 2)
    rot = np.zeros((2, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(theta)
    rot[:, 0, 1], rot[:, 1, 0] = np.sin(theta), -np.sin(theta)
    rot[:, 2, 2] = 1
    d2i = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    d2i[:, :3, :3] = np.array([[500, 0, 300], [0, 500, 200], [0, 0, 1]],
                              np.float32) @ np.array(
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    meta = dict(img_shape=np.array([[400, 600], [380, 590]], np.int32),
                scale_factor=rng.uniform(0.8, 1.2, (2, 2)).astype(np.float32),
                flip=np.array([False, True]), depth2img=d2i,
                pcd_rotation=rot,
                pcd_scale_factor=rng.uniform(0.9, 1.1, 2).astype(np.float32),
                pcd_trans=rng.randn(2, 3).astype(np.float32) * 0.1,
                pcd_horizontal_flip=np.array([True, False]))
    got = transforms.project_points_to_image(
        _t(pts), {k: _t(v) for k, v in meta.items()})
    want = jtransforms.project_points_to_image(
        jnp.asarray(pts), {k: jnp.asarray(v) for k, v in meta.items()})
    assert _rel(got, want) < 1e-5


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors only: there is no silent
    fallback to the plain version."""
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match='CUDA'):
        sampling.furthest_point_sample_cuda(xyz, 4)
    with pytest.raises(ValueError, match='CUDA'):
        grouping.ball_query_cuda(0.2, 4, xyz, xyz)
    with pytest.raises(ValueError, match='CUDA'):
        msda.msda_cuda(torch.zeros(1, 2, 1, 4), ((1, 2),),
                       torch.zeros(1, 1, 1, 1, 1, 2), torch.zeros(1, 1, 1, 1,
                                                                  1))
