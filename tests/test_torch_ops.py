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


@pytest.mark.parametrize('n', [1, 33, 512, 513, 999, 2048, 2049, 20000,
                               sampling.FPS_MAX_POINTS])
def test_fps_launch_shape_holds_the_points(n):
    """K1's cluster and block sizes by N: within what csrc/fps.cu takes (a
    cluster of 1..8 blocks of whole warps, at most 512 threads, at most
    16 points a thread)."""
    cluster, threads = sampling.fps_launch_shape(n)
    assert 1 <= cluster <= 8
    assert threads % 32 == 0 and 32 <= threads <= 512
    share = -(-n // cluster)
    assert -(-share // threads) <= 16
    assert cluster * threads * 16 >= n


def test_fps_launch_shape_bounds():
    assert sampling.FPS_MAX_POINTS >= 32768
    for n in (0, -1, sampling.FPS_MAX_POINTS + 1):
        with pytest.raises(ValueError, match='points'):
            sampling.fps_launch_shape(n)
    # one block for the small calls of the point branch, a cluster for SA0
    assert sampling.fps_launch_shape(1024)[0] == 1
    assert sampling.fps_launch_shape(20000)[0] > 1


def _tile_queries(shapes, rows):
    """The tokens that K3's tile blocks take as queries, tile by tile, by
    the kernel's rule: query i of a tile is pixel (i // tile W, i % tile W)
    of the tile, kept where it lies inside the level."""
    out, start = [], 0
    for (h, w), (th, tw, across, tiles, first) in zip(shapes, rows):
        for t in range(tiles):
            y0, x0 = (t // across) * th, (t % across) * tw
            tile = [start + (y0 + i // tw) * w + x0 + i % tw
                    for i in range(th * tw)
                    if y0 + i // tw < h and x0 + i % tw < w]
            assert tile, (h, w, t)
            out.append(tile)
        start += h * w
    return out


@pytest.mark.parametrize('shapes,hd', [
    (((100, 168), (50, 84), (25, 42), (13, 21)), 32),
    (((100, 168), (50, 84), (25, 42), (13, 21)), 64),
    (((32, 48), (16, 24), (8, 12)), 8),
    (((16, 24), (8, 12)), 16),
    (((7, 5),), 16),
    (((8, 12), (40, 60)), 32)])
def test_msda_tiling_covers_each_tiled_token_once(shapes, hd):
    rows, tiles, direct_from = msda.msda_tiling(shapes, hd)
    most = min(msda.MSDA_TILE_SIDE ** 2,
               msda.MSDA_MAX_PASSES * (msda.MSDA_THREADS // (hd // 4)))
    assert len(rows) == len(shapes)
    tiled = [r for r in rows if r[3]]
    # tiled levels come first, their tiles are numbered in order
    assert rows[:len(tiled)] == tiled
    assert sum(r[3] for r in rows) == tiles
    first = 0
    for th, tw, across, count, start in rows:
        assert start == first
        first += count
        if count:
            assert msda.MSDA_MIN_TILE <= th * tw <= most
    assert direct_from == sum(h * w for h, w in shapes[:len(tiled)])
    queries = _tile_queries(shapes, rows)
    assert len(queries) == tiles
    flat = sorted(q for tile in queries for q in tile)
    assert flat == list(range(direct_from))


def test_msda_tiling_at_the_encoder_shape():
    """16 x 16 pixels on the finest level, 8 x 8 on the next (the same
    footprint), the two coarse levels query-major."""
    rows, tiles, direct_from = msda.msda_tiling(
        ((100, 168), (50, 84), (25, 42), (13, 21)), 32)
    assert rows[0][:2] == (16, 16) and rows[1][:2] == (8, 8)
    assert rows[2][3] == rows[3][3] == 0
    assert tiles == 2 * 7 * 11 and direct_from == 100 * 168 + 50 * 84


def test_msda_tables_are_built_once():
    shapes = ((8, 12), (4, 6))
    cpu = torch.device('cpu')
    first = msda._tables(shapes, 32, True, cpu)
    again = msda._tables([[8, 12], [4, 6]], 32, True, cpu)
    assert all(a is b for a, b in zip(first, again))
    level_info, tile_info, tiles, direct_from, max_tile = first
    assert level_info.dtype == tile_info.dtype == torch.int32
    assert level_info.tolist() == [[8, 12, 0], [4, 6, 96]]
    assert tuple(tile_info.shape) == (2, 5)
    rows, want_tiles, want_from = msda.msda_tiling(shapes, 32)
    assert tile_info.tolist() == [list(r) for r in rows]
    assert (tiles, direct_from) == (want_tiles, want_from)
    # the largest tile, which the kernel's entry point holds to its limits
    assert max_tile == max(th * tw for th, tw, *_ in rows) > 0
    untiled = msda._tables(shapes, 32, False, cpu)
    assert untiled[2:] == (0, 0, 0) and not untiled[1].any()
    assert untiled[0].tolist() == level_info.tolist()


def test_encoder_sampling_locations_are_the_modules():
    """The tools' encoder-like locations, without noise, are what the MSDA
    layer makes at its DETR init from reference points at the pixel
    centres."""
    from demf_tpu_torch.models.transformer import (
        MultiScaleDeformableAttention)
    from demf_tpu_torch.tools import encoder_sampling_locations
    shapes = ((6, 8), (3, 4))
    s = sum(h * w for h, w in shapes)
    layer = MultiScaleDeformableAttention(32, 4, 2, 3)
    layer.init_weights(torch.Generator().manual_seed(0))
    got = encoder_sampling_locations(shapes, 2, 4, 3, 'cpu', jitter=0.0)
    assert tuple(got.shape) == (2, s, 4, 2, 3, 2)
    ref = torch.cat([torch.stack(torch.meshgrid(
        (torch.arange(w) + 0.5) / w, (torch.arange(h) + 0.5) / h,
        indexing='xy'), -1).reshape(h * w, 2) for h, w in shapes])
    offsets = layer.sampling_offsets(torch.zeros(2, s, 32)).reshape(
        2, s, 4, 2, 3, 2)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    want = ref[None, :, None, None, None] + offsets / wh[:, None]
    assert (got - want).abs().max() < 1e-6
    noisy = encoder_sampling_locations(shapes, 2, 4, 3, 'cpu', seed=1)
    assert 0 < (noisy - got).abs().max() < 1.0


def test_msda_rows_touched_counts_distinct_rows_inside_the_map():
    from demf_tpu_torch.tools import bound_ms, msda_rows_touched
    shapes = ((4, 6), (2, 3))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(0)
    locs = rng.uniform(-0.3, 1.3, (2, 5, 3, 2, 2, 2)).astype(np.float32)
    seen, start = set(), 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = np.floor(locs[:, :, :, lvl, :, 0] * np.float32(w) -
                      np.float32(0.5)).astype(int)
        y0 = np.floor(locs[:, :, :, lvl, :, 1] * np.float32(h) -
                      np.float32(0.5)).astype(int)
        for (b, q, hd, p), x in np.ndenumerate(x0):
            for yy in (y0[b, q, hd, p], y0[b, q, hd, p] + 1):
                for xx in (x, x + 1):
                    if 0 <= xx < w and 0 <= yy < h:
                        seen.add((b, start + yy * w + xx, hd))
        start += h * w
    assert 0 < len(seen) < 2 * s * 3
    assert msda_rows_touched(shapes, _t(locs)) == len(seen)
    far = np.full_like(locs, 5.0)
    assert msda_rows_touched(shapes, _t(far)) == 0
    # 6.7 GFLOP at 67 TFLOP/s against 3.35 MB at 3.35 TB/s, and the reverse
    assert bound_ms(6.7e9, 3.35e6) == (pytest.approx(0.1), 'operations')
    assert bound_ms(6.7e6, 3.35e9) == (pytest.approx(1.0), 'bytes')
