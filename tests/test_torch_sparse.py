"""The port's sparse-convolution ops (``demf_tpu_torch/ops/sparse.py``)
against the JAX package's (``demf_tpu/ops/sparse.py``), on the CPU, on the
same inputs made with numpy from a seed.

* ``voxelize``: coordinates and validity equal, features within 1e-6, with
  points out of the grid and with more voxels than the capacity;
* every table in sorted-key, valid-prefix order (what ``sorted_input=True``
  asserts);
* the kernel maps (K13's plain version) equal to
  ``neighbor_table_batched`` for k = 1, 2, 3 at tensor strides 1, 2, 4, on
  presorted and on shuffled tables; the stride and pool coordinate sets
  equal;
* the submanifold, strided and transposed convolutions (K14's plain
  version; the port's kernels in MinkowskiEngine's tap order, the JAX
  package's permuted by ``engine/weights.py::me_tap_order``) and the max
  pool within 1e-5 of each output's largest value;
* a bfloat16 convolution held to the JAX package's own bf16 - float32 gap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.ops import sparse as J
from demf_tpu_torch.engine.weights import me_tap_order
from demf_tpu_torch.ops import sparse as P

VOXEL = 0.1


def cloud(seed, b=2, n=1500, lo=-0.3, hi=3.0):
    """Points over a box (some below 0, so out of the grid) with rgb."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)
    return pts, rng.rand(b, n, 3).astype(np.float32)


def port_voxels(pts, feats, m):
    return P.voxelize(torch.from_numpy(pts), torch.from_numpy(feats), VOXEL,
                      (0.0, 0.0, 0.0), m)


def jax_voxels(pts, feats, m):
    return jax.device_get(jax.vmap(lambda p, f: J.voxelize(
        p, f, VOXEL, jnp.zeros(3), m))(pts, feats))


@pytest.fixture(scope='module')
def level():
    """A scene pair's voxel tables (capacity 2048, about 1,600 voxels
    each) as torch tensors."""
    pts, feats = cloud(0)
    return port_voxels(pts, feats, 2048)


def at_stride(level, stride):
    coords, _, valid = level
    if stride == 1:
        return coords, valid
    return P.downsample_coords(coords, valid, stride, coords.shape[1])


@pytest.mark.parametrize('case', ['spread', 'out_of_grid', 'over_capacity'])
def test_voxelize_equals_jax(case):
    pts, feats = cloud(1, lo=-0.3 if case == 'out_of_grid' else 0.0)
    m = 256 if case == 'over_capacity' else 4096
    coords, vfeats, valid = port_voxels(pts, feats, m)
    jc, jf, jv = jax_voxels(pts, feats, m)
    assert np.array_equal(coords.numpy(), jc)
    assert np.array_equal(valid.numpy(), jv)
    assert np.abs(vfeats.numpy() - jf).max() <= 1e-6
    n_valid = int(valid.sum())
    if case == 'over_capacity':
        assert n_valid == 2 * m
    else:
        assert 0 < n_valid < 2 * m
    if case == 'out_of_grid':
        assert (pts < 0).any()


def keys_sorted(coords, valid):
    keys = torch.where(valid, P.linearize(coords), P.KEY_PAD)
    prefix = valid.long().cumsum(1) == torch.arange(
        1, valid.shape[1] + 1)[None] * valid.long()
    return bool((keys[:, 1:] > keys[:, :-1]).logical_or(
        keys[:, 1:] == P.KEY_PAD).all()) and bool(
        (prefix | ~valid).all()) and bool(
        (valid[:, 1:] <= valid[:, :-1]).all())


@pytest.mark.parametrize('stride', [1, 2, 4, 8])
def test_tables_are_sorted_with_a_valid_prefix(level, stride):
    coords, valid = at_stride(level, stride)
    assert keys_sorted(coords, valid)
    assert (coords[~valid] == P.INVALID).all()


@pytest.mark.parametrize('stride', [2, 4])
def test_downsample_coords_equal_jax(level, stride):
    coords, _, valid = level
    got = P.downsample_coords(coords, valid, stride, 1024)
    want = jax.device_get(jax.vmap(lambda c, v: J.downsample_coords(
        c, v, stride, 1024))(coords.numpy(), valid.numpy()))
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize('presorted', [True, False])
@pytest.mark.parametrize('stride', [1, 2, 4])
@pytest.mark.parametrize('k', [1, 2, 3])
def test_kernel_map_equals_jax(level, k, stride, presorted):
    coords, valid = at_stride(level, stride)
    if not presorted:
        # the same table with its rows shuffled: the table is sorted first
        perm = torch.from_numpy(np.random.RandomState(k).permutation(
            coords.shape[1]))
        coords, valid = coords[:, perm], valid[:, perm]
    got = P.neighbor_table_batched(coords, valid, coords, valid,
                                   P.kernel_offsets(k), in_stride=stride,
                                   sorted_input=presorted)
    want = J.neighbor_table_batched(
        jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
        jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
        J.kernel_offsets(k), in_stride=stride, sorted_input=presorted)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).any() and (got < 0).any()


def test_kernel_offsets_orders():
    for k in (1, 2, 3):
        assert np.array_equal(P.kernel_offsets(k).numpy(),
                              np.asarray(J.kernel_offsets(k)))
    me = P.kernel_offsets(3, me_order=True)
    assert me[1].tolist() == [0, -1, -1] and me[3].tolist() == [-1, 0, -1]
    assert sorted(map(tuple, me.tolist())) == sorted(
        map(tuple, P.kernel_offsets(3).tolist()))


def weights(seed, k, c, co):
    return (np.random.RandomState(seed).randn(k ** 3, c, co) /
            np.sqrt(k ** 3 * c)).astype(np.float32)


def feats_of(valid, c, seed):
    x = np.random.RandomState(seed).randn(*valid.shape, c).astype(np.float32)
    return x * valid.numpy()[..., None]


def close(got, want, tol=1e-5):
    want = np.asarray(want)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.mark.parametrize('stride', [1, 2, 4])
def test_submanifold_conv_equals_jax(level, stride):
    coords, valid = at_stride(level, stride)
    x, w = feats_of(valid, 8, 1), weights(2, 3, 8, 16)
    want = J.submanifold_conv_batched(
        jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
        jnp.asarray(x), jnp.asarray(w),
        tensor_stride=stride, sorted_input=True)
    got = P.submanifold_conv_batched(
        coords, valid, torch.from_numpy(x), torch.from_numpy(me_tap_order(w)),
        tensor_stride=stride, sorted_input=True)
    close(got, want)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('k', [2, 3])
def test_strided_conv_equals_jax(level, k, stride):
    coords, valid = at_stride(level, stride)
    x, w = feats_of(valid, 8, 3), weights(4, k, 8, 16)
    want = J.strided_conv_batched(
        jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
        jnp.asarray(x), jnp.asarray(w),
        kernel_size=k, max_out=1024, tensor_stride=stride, sorted_input=True)
    got = P.strided_conv_batched(
        coords, valid, torch.from_numpy(x), torch.from_numpy(me_tap_order(w)),
        kernel_size=k, max_out=1024, tensor_stride=stride, sorted_input=True)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2])


def test_max_pool_equals_jax(level):
    coords, valid = at_stride(level, 2)
    x = feats_of(valid, 8, 5)
    want = J.sparse_max_pool_batched(
        jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
        jnp.asarray(x), max_out=1024, tensor_stride=2, sorted_input=True)
    got = P.sparse_max_pool_batched(coords, valid, torch.from_numpy(x),
                                    max_out=1024, tensor_stride=2,
                                    sorted_input=True)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[2], want[2], 0)


@pytest.mark.parametrize('fine_stride', [1, 2, 4])
def test_transposed_conv_equals_jax(level, fine_stride):
    fine_c, fine_v = at_stride(level, fine_stride)
    coarse_c, coarse_v = P.downsample_coords(fine_c, fine_v, 2 * fine_stride,
                                             fine_c.shape[1] // 2)
    x, w = feats_of(coarse_v, 8, 6), weights(7, 2, 8, 16)
    want = J.transposed_conv_to_batched(
        jnp.asarray(fine_c.numpy()), jnp.asarray(fine_v.numpy()),
        jnp.asarray(coarse_c.numpy()), jnp.asarray(coarse_v.numpy()),
        jnp.asarray(x), jnp.asarray(w),
        tensor_stride=fine_stride, sorted_input=True, sorted_fine=True)
    got = P.transposed_conv_to_batched(
        fine_c, fine_v, coarse_c, coarse_v, torch.from_numpy(x),
        torch.from_numpy(me_tap_order(w)), tensor_stride=fine_stride,
        sorted_input=True)
    close(got, want)


def test_global_max_pool_equals_jax(level):
    coords, _, valid = level
    x = feats_of(valid, 4, 8)[0]
    close(P.global_max_pool(torch.from_numpy(x), valid[0]),
          J.global_max_pool(x, valid[0].numpy()), 0)


def test_bf16_conv_within_the_jax_bf16_gap(level):
    """K14's plain version on bfloat16 rows sums in float32 and rounds once;
    the JAX scan adds its taps in bfloat16.  Each rounds its inputs the
    same way, so the port's bf16 output lies within the JAX package's own
    bf16 - float32 gap of JAX's bf16 output, and its own gap is no larger
    than twice JAX's."""
    coords, valid = at_stride(level, 1)
    x, w = feats_of(valid, 16, 9), weights(10, 3, 16, 16)
    nbr = P.neighbor_table_batched(coords, valid, coords, valid,
                                   P.kernel_offsets(3), sorted_input=True)
    jnbr = jnp.asarray(nbr.numpy())
    want32 = np.asarray(J.sparse_conv_apply_batched(
        jnp.asarray(x), jnbr, jnp.asarray(w)))
    want16 = np.asarray(J.sparse_conv_apply_batched(
        jnp.asarray(x, jnp.bfloat16), jnbr, jnp.asarray(w, jnp.bfloat16)),
        np.float32)
    got16 = P.sparse_conv_apply_batched(
        torch.from_numpy(x).bfloat16(), nbr,
        torch.from_numpy(w).bfloat16())
    assert got16.dtype == torch.bfloat16
    got16 = got16.float().numpy()
    jax_gap = np.abs(want16 - want32).max()
    assert 0 < np.abs(got16 - want32).max() <= jax_gap
    assert np.abs(got16 - want16).max() <= 2 * jax_gap
