"""What of the redesigned ball query (K2) and M-form sampler (K7) runs
without a card: the streaming top-K rule of K2 in plain Python against the
plain version and the JAX package, index for index, and the launch shapes
the wrappers hand to the kernels.  Indices are compared exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demf_tpu import ops as jops
from demf_tpu_torch.ops import grouping, mform
from demf_tpu_torch.ops._cuda import SMEM_PER_BLOCK


def _scene(seed, n, m, extent=1.0, twice=0):
    """(1, N, 3) points uniform over a cube, the first ``twice`` of them
    again at N // 2 on; the first M are the centers."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-extent, extent, (1, n, 3)).astype(np.float32)
    pts[:, n // 2:n // 2 + twice] = pts[:, :twice]
    return torch.from_numpy(pts), torch.from_numpy(pts[:, :m].copy())


# name: (N, M, K, radius, points twice, tile, cap)
STREAMED_CASES = {
    # equal distances: the lower index wins, also across a pruning
    'duplicated points': (400, 12, 8, 0.6, 150, 64, 64),
    # every point in the radius, many times the list
    'more than cap in the radius': (500, 6, 16, 5.0, 0, 128, 64),
    'fewer than K': (300, 10, 32, 0.25, 0, 64, 64),
    'an empty ball': (200, 5, 4, 1e-4, 0, 64, 64),
    'N smaller than a tile': (50, 7, 8, 0.8, 10, 512, 64),
    'K larger than N': (20, 4, 40, 5.0, 5, 32, 128),
}


@pytest.mark.parametrize('case', sorted(STREAMED_CASES))
@pytest.mark.parametrize('distances', [grouping.sqdist,
                                       grouping.sqdist_unfused])
def test_streamed_top_k_equals_plain(case, distances):
    n, m, k, radius, twice, tile, cap = STREAMED_CASES[case]
    pts, centers = _scene(len(case), n, m, twice=twice)
    if case == 'an empty ball':
        centers = centers + 7.0
    want = grouping.ball_query_plain(radius, k, pts, centers,
                                     distances=distances)
    got = grouping.ball_query_streamed_plain(radius, k, pts, centers, tile,
                                             cap, distances=distances)
    assert torch.equal(got, want)
    inside = (distances(centers, pts) < radius * radius).sum(-1)
    if case == 'more than cap in the radius':
        assert int(inside.min()) > cap
    if case == 'fewer than K':
        assert 0 < int(inside.max()) < k
    if case == 'an empty ball':
        assert int(inside.max()) == 0 and int(got.abs().max()) == 0


def test_streamed_top_k_matches_jax_exact_on_duplicates():
    """Against the JAX package's exact ball query where equal distances
    decide the picks: every point occurs twice, so each center's K-th
    neighbour has a twin and the lower index must win."""
    rng = np.random.RandomState(3)
    half = rng.uniform(-1, 1, (2, 150, 3)).astype(np.float32)
    pts = np.concatenate([half, half], 1)
    centers = pts[:, :20]
    got = grouping.ball_query_streamed_plain(
        0.7, 9, torch.from_numpy(pts), torch.from_numpy(centers), 64, 64)
    want = np.asarray(jops.ball_query(0.7, 9, jnp.asarray(pts),
                                      jnp.asarray(centers), exact=True))
    d2 = grouping.sqdist(torch.from_numpy(centers), torch.from_numpy(pts))
    assert int((d2 < 0.49).sum(-1).min()) >= 9
    # a twin pair straddles the K-th slot wherever the 9th pick is the
    # first of its pair
    assert (got.numpy()[..., 8] < 150).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_streamed_top_k_refuses_a_short_list():
    pts, centers = _scene(0, 40, 2)
    with pytest.raises(ValueError, match='cap >= nsample'):
        grouping.ball_query_streamed_plain(0.5, 40, pts, centers, 32, 64)


def test_unfused_distances_are_the_formula_of_sqdist():
    pts, centers = _scene(5, 300, 30, extent=3.0)
    got = grouping.sqdist_unfused(centers, pts)
    want = grouping.sqdist(centers, pts)
    assert got.shape == want.shape == (1, 30, 300)
    assert (got - want).abs().max() < 1e-5     # float32 at |x|^2 <= 27


# (points, centers, picks) of the four SA modules and the vote aggregation
PATH_SHAPES = ((20000, 2048, 64), (2048, 1024, 32), (1024, 512, 16),
               (512, 256, 16), (1024, 256, 16))


@pytest.mark.parametrize('b', [16, 2])
@pytest.mark.parametrize('n,m,k', PATH_SHAPES)
def test_ball_query_launch_shape_fits_every_path_shape(b, n, m, k):
    warps, per_warp, cap, tile = grouping.ball_query_launch_shape(b, m, n, k)
    assert 1 <= warps <= 16 and per_warp in (1, 2, 4, 8)
    assert cap >= k + 32 and cap & (cap - 1) == 0
    assert tile % 32 == 0 and tile >= 32
    assert grouping.ball_query_smem_bytes(warps, per_warp, cap,
                                          tile) <= SMEM_PER_BLOCK
    # about a block an SM of the card's 132 or more, but for the two calls
    # of 512 centers in all, whose time is the launch's
    assert b * -(-m // (warps * per_warp)) >= min(128, b * m // 8)


def test_ball_query_launch_shape_shrinks_the_block_for_a_long_list():
    """K 900 needs lists of 1,024 keys: 32 of them do not fit one block,
    so the block takes fewer centers; K 30,000 fits none and raises."""
    warps, per_warp, cap, tile = grouping.ball_query_launch_shape(
        2, 8, 6000, 900)
    assert cap == 1024 and warps * per_warp < 32
    assert grouping.ball_query_smem_bytes(warps, per_warp, cap,
                                          tile) <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match='does not fit'):
        grouping.ball_query_launch_shape(2, 8, 6000, 30000)
    with pytest.raises(ValueError, match='>= 1'):
        grouping.ball_query_launch_shape(2, 8, 0, 4)


@pytest.mark.parametrize('hd', [16, 32, 64])
@pytest.mark.parametrize('plane_size,w_size', [(2, 2), (2, 4), (4, 2),
                                               (4, 4)])
def test_mform_launch_shape_fits(hd, plane_size, w_size):
    q_tile, threads = mform.mform_launch_shape(16, hd, plane_size, w_size)
    assert q_tile % 8 == 0 and 8 <= q_tile <= 512
    assert threads % 32 == 0 and threads <= 512
    assert mform.mform_smem_bytes(16, q_tile, w_size) <= SMEM_PER_BLOCK


def test_mform_launch_shape_refuses_what_does_not_fit():
    """A row that is no whole number of 16-byte pieces, and more slots
    than a block's shared memory holds for 8 queries; many slots shrink
    the tile first."""
    with pytest.raises(ValueError, match='16-byte pieces'):
        mform.mform_launch_shape(16, 12, 2, 2)
    with pytest.raises(ValueError, match='16-byte pieces'):
        mform.mform_launch_shape(16, 6, 4, 4)
    q_tile, _ = mform.mform_launch_shape(1000, 32, 2, 4)
    assert q_tile < 512
    assert mform.mform_smem_bytes(1000, q_tile, 4) <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match='do not fit'):
        mform.mform_launch_shape(5000, 32, 2, 4)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    pts, centers = _scene(9, 200, 8)
    before = (grouping.BALL_QUERY_KERNEL.launches,
              mform.MFORM_KERNEL.launches)
    got = grouping.ball_query(0.5, 6, pts, centers)
    assert torch.equal(got, grouping.ball_query_plain(0.5, 6, pts, centers))
    plane = torch.randn(2, 30, 10)       # a width the kernel would refuse
    idx16 = torch.randint(0, 30, (2, 4, 9, 1), dtype=torch.int32)
    w16 = torch.rand(2, 4, 9, 1)
    assert torch.equal(mform.mform_sample(plane, idx16, w16),
                       mform.mform_sample_plain(plane, idx16, w16))
    assert before == (grouping.BALL_QUERY_KERNEL.launches,
                      mform.MFORM_KERNEL.launches)
