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
  pool within 1e-5 of each output's largest value; the tables a strided
  conv hands out (its own, whose tap 0 a stride-2 block's shortcut reads,
  and the coarse level's, from one launch) and the transposed conv's made
  up front as the FCAF3D head makes them, equal to the JAX package's
  and to ``transposed_table``'s;
* a bfloat16 convolution held to the JAX package's own bf16 - float32 gap;
* K14's row plan (``conv_plan``) of every table those convolutions read
  (the ``tiles`` cases): every row once in the order, sorted stably by its
  tap mask, every tap a row has in its tile's list; and the plain walk of
  the plan's tiles in the kernel's order (``sparse_conv_tiles_plain``, the
  whole list a part and 2 taps a part) within 1e-5 of
  ``sparse_conv_plain``, rows with no tap
  exactly 0, and the convolution so computed held to the JAX package's as
  the plain one is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.ops import sparse as J
from demf_tpu_torch.engine.weights import me_tap_order
from demf_tpu_torch.models.fcaf3d import FCAF3DHead
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


def check_plan(nbr, plan):
    """K14's row plan of ``nbr``: each row's mask, every row once in the
    order, the order sorted stably by mask, and every (row, tap) with a
    neighbour inside its tile's tap list."""
    b, m, k = nbr.shape
    hit = nbr >= 0
    bits = 1 << torch.arange(k)
    assert torch.equal(plan.mask, (hit.long() * bits).sum(-1).int())
    order = plan.order.long()
    rows = torch.arange(m).expand(b, m)
    assert torch.equal(order.sort(1).values, rows)
    smask = plan.mask.gather(1, order)
    assert (smask[:, 1:] >= smask[:, :-1]).all()
    same = smask[:, 1:] == smask[:, :-1]
    assert (order[:, 1:] > order[:, :-1])[same].all()
    place = torch.empty_like(order).scatter_(1, order, rows)
    listed = plan.tile_taps.gather(1, place // P.CONV_TILE_ROWS)
    assert ((listed[..., None].long() & bits) != 0)[hit].all()
    assert plan.tile_taps.shape == (b, -(-m // P.CONV_TILE_ROWS))


def route_through_tiles(monkeypatch):
    """Make the port's convolutions go through the plain walk of their
    plans' tiles (whole lists, and parts of 2 taps), each checked against
    the plain version on the way."""
    plain = P.sparse_conv_plain

    def walk(feats, nbr, weights):
        plan = P.conv_plan(nbr)
        check_plan(nbr, plan)
        want = plain(feats, nbr, weights)
        empty = plan.mask == 0
        assert empty.any()
        outs = [P.sparse_conv_tiles_plain(feats, nbr, weights, plan, group)
                for group in (None, 2)]
        for got in outs:
            close(got, want.numpy())
            assert (got[empty] == 0).all()
        return outs[1]
    monkeypatch.setattr(P, 'sparse_conv_plain', walk)


@pytest.mark.parametrize('route', ['plain', 'tiles'])
@pytest.mark.parametrize('stride', [1, 2, 4])
def test_submanifold_conv_equals_jax(level, stride, route, monkeypatch):
    if route == 'tiles':
        route_through_tiles(monkeypatch)
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


def me_perm(k):
    """Tap t of MinkowskiEngine's order (the first axis fastest) at the JAX
    package's index (the last axis fastest)."""
    t = np.arange(k ** 3)
    return (t % k) * k * k + (t // k % k) * k + t // (k * k)


@pytest.mark.parametrize('level_kernel', [None, 3])
@pytest.mark.parametrize('route', ['plain', 'tiles'])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('k', [2, 3])
def test_strided_conv_equals_jax(level, k, stride, route, level_kernel,
                                 monkeypatch):
    """The strided conv, its coordinate set and its table; for k = 2 the
    table's tap 0, which a stride-2 block's shortcut reads, equal to the
    JAX package's one-tap table onto the coarse set; with
    ``level_kernel`` the coarse level's own table from the same launch
    equal to the JAX package's 27-tap table in MinkowskiEngine's order."""
    if route == 'tiles':
        route_through_tiles(monkeypatch)
    coords, valid = at_stride(level, stride)
    x, w = feats_of(valid, 8, 3), weights(4, k, 8, 16)
    want = J.strided_conv_batched(
        jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
        jnp.asarray(x), jnp.asarray(w),
        kernel_size=k, max_out=1024, tensor_stride=stride, sorted_input=True)
    got = P.strided_conv_batched(
        coords, valid, torch.from_numpy(x), torch.from_numpy(me_tap_order(w)),
        kernel_size=k, max_out=1024, tensor_stride=stride, sorted_input=True,
        level_kernel=level_kernel)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2])
    oc, ov = (jnp.asarray(t.numpy()) for t in got[:2])
    jc, jv = jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy())
    if k == 2:
        one_tap = J.neighbor_table_batched(jc, jv, oc, ov, J.kernel_offsets(1),
                                           in_stride=stride,
                                           sorted_input=True)
        assert np.array_equal(got[3][..., :1].numpy(), np.asarray(one_tap))
    if level_kernel:
        table = J.neighbor_table_batched(oc, ov, oc, ov, J.kernel_offsets(3),
                                         in_stride=2 * stride,
                                         sorted_input=True)
        assert np.array_equal(got[4].numpy(),
                              np.asarray(table)[..., me_perm(3)])
    else:
        assert got[4] is None


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


def pool_rows(valid, kind, dtype):
    """A level's rows for the pool: ``randn``, ``relu`` (post-ReLU rows:
    zeros tie), ``ties`` (positive halves: exact ties of the maximum),
    ``nonfinite`` (NaN, inf and -inf in some rows: their outputs 0)."""
    x = feats_of(valid, 8, 5).astype(np.float64)
    if kind == 'relu':
        x = np.maximum(x, 0)
    elif kind == 'ties':
        x = (np.round(np.abs(x) * 2) + 1) / 2 * valid.numpy()[..., None]
    elif kind == 'nonfinite':
        x[:, 10:40:3, 1] = np.nan
        x[:, 11:41:3, 2] = np.inf
        x[:, 12:42:3, 3] = -np.inf
    return x.astype(dtype)


def same_bits(got, want):
    got = np.ascontiguousarray(np.asarray(got))
    want = np.ascontiguousarray(np.asarray(want))
    ints = {4: np.int32, 8: np.int64}[got.itemsize]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(ints), want.view(ints))


@jax.jit
def jax_pool_and_grad(coords, valid, feats, ct):
    """The JAX package's pool of a level at stride 2 onto 1,024 rows and its
    vjp with ``ct`` (one compile a dtype)."""
    out, vjp = jax.vjp(lambda f: J.sparse_max_pool_batched(
        coords, valid, f, max_out=1024, tensor_stride=2,
        sorted_input=True)[2], feats)
    return out, vjp(ct)[0]


@pytest.fixture
def one_thread():
    """The test on one intra-op thread: small ops under the other test
    workers' threads slow by tens of times with torch's default pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('kind', ['randn', 'relu', 'ties', 'nonfinite'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_max_pool_gradient_equals_jax(level, dtype, kind, one_thread):
    """The pool's output and its gradient (autograd of the chain) against
    ``jax.vjp`` of the JAX package's at tolerance 0, ties and non-finite
    rows included (both halve the gradient on a tie); K17's order in plain
    torch (its mask and output, its shares) the chain's bits."""
    coords, valid = at_stride(level, 2)
    x = pool_rows(valid, kind, dtype)
    ct = np.random.RandomState(7).randn(x.shape[0], 1024, x.shape[2]).astype(
        dtype)
    with jax.enable_x64(dtype == np.float64):
        want, want_g = jax_pool_and_grad(
            jnp.asarray(coords.numpy()), jnp.asarray(valid.numpy()),
            jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    oc, ov, got = P.sparse_max_pool_batched(coords, valid, xt, max_out=1024,
                                            tensor_stride=2,
                                            sorted_input=True)
    got.backward(torch.from_numpy(ct))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want_g))
    nbr = P.kernel_tables([P.TableJob(coords, valid, oc, ov, 2, False, 2)],
                          True)[0]
    plain, mask = P.sparse_max_pool_mask_plain(torch.from_numpy(x), nbr, ov)
    shares = P.sparse_max_pool_backward_plain(torch.from_numpy(ct), nbr,
                                              mask, x.shape[1])
    same_bits(plain.numpy(), got.detach().numpy())
    same_bits(shares.numpy(), xt.grad.numpy())
    tied = (mask.int() & (mask.int() - 1)) > 0
    assert tied.any() == (kind in ('relu', 'ties'))


def walk_case(kind, dtype, b=2, m_out=96, seed=3):
    """A pool table in which output row o reads input rows 8 o + t (taps
    absent at random, every tap of some rows present, a tenth of the rows
    invalid; half the input rows have no reader) and rows of ``kind``:
    ``ties`` values of {1, 2} (ties of 2 to 8 taps), ``nonfinite`` with
    NaN, inf and -inf planted, ``zeros`` of +0, -0 and -1.  Returns (rows
    (B, 16 M_out, 8), table, out_valid, an output gradient)."""
    rng = np.random.RandomState(seed)
    k, c = 8, 8
    nbr = np.arange(m_out)[:, None] * k + np.arange(k)
    nbr = np.where(rng.rand(b, m_out, k) < 0.4, -1, nbr)
    nbr[:, ::5] = np.arange(m_out)[::5, None] * k + np.arange(k)
    valid = rng.rand(b, m_out) > 0.1
    if kind == 'ties':
        x = rng.randint(1, 3, (b, 2 * k * m_out, c)).astype(np.float32)
    elif kind == 'zeros':
        x = rng.choice(np.array([0.0, -0.0, -1.0], np.float32),
                       (b, 2 * k * m_out, c))
    else:
        x = rng.randn(b, 2 * k * m_out, c).astype(np.float32)
        for col, v in enumerate((np.nan, np.inf, -np.inf)):
            x[:, col::13, col] = v
    grad = rng.randn(b, m_out, c).astype(np.float32)
    grad[:, ::7] = -0.0
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(nbr.astype(
        np.int32)), torch.from_numpy(valid),
        torch.from_numpy(grad).to(dtype))


def pool_walk(x, nbr, out_valid):
    """K17's forward walk in plain torch: the taps in order, (running
    maximum in the rows' type, bits of the taps equal to it), a greater
    tap clearing the bits and an equal one adding its bit; an invalid row
    reads no tap; a non-finite maximum or invalid row writes 0 and no
    bits."""
    b, m_out, k = nbr.shape
    acc = x.new_full((b, m_out, x.shape[2]), float('-inf'))
    bits = torch.zeros(acc.shape, dtype=torch.int32)
    for t in range(k):
        idx = nbr[..., t].long()
        here = ((idx >= 0) & out_valid)[..., None]
        y = torch.gather(x, 1, idx.clamp(min=0)[..., None].expand_as(acc))
        bit = 1 << t
        bits = torch.where(here & (y > acc), bit,
                           torch.where(here & (y == acc), bits | bit, bits))
        acc = torch.where(here, torch.maximum(acc, y), acc)
    keep = torch.isfinite(acc) & out_valid[..., None]
    return torch.where(keep, acc, 0), torch.where(keep, bits, 0).to(
        torch.uint8)


def pool_backward_walk(grad, reader, nbr, mask):
    """K17's backward in plain torch, an input row at a time as its threads
    run: 0 unless its index entry names a tap of the table that reads it,
    else the reader's gradient halved (in the rows' type, one halving at a
    time) once a mask bit at or above its tap, the lowest bit not counted,
    0 off the mask; written 0 + share."""
    b, m_in = reader.shape
    m_out, k = nbr.shape[1:]
    d = grad.new_zeros((b, m_in, grad.shape[2]))
    for s in range(b):
        for i in range(m_in):
            who = int(reader[s, i])
            o, tap = divmod(who, P.MAX_POOL_TAPS)
            if who < 0 or o >= m_out or tap >= k or int(nbr[s, o, tap]) != i:
                continue
            for ch in range(grad.shape[2]):
                bits = int(mask[s, o, ch])
                share = grad.new_zeros(())
                if bits >> tap & 1:
                    share = grad[s, o, ch].clone()
                    low = bits & -bits == 1 << tap
                    for _ in range(bin(bits >> tap).count('1') - low):
                        share = share * 0.5
                d[s, i, ch] = 0 + share
    return d


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['ties', 'nonfinite', 'zeros'])
def test_max_pool_walk_equals_mask_plain(kind, dtype, one_thread):
    """K17's redesigned order in plain torch: the tie mask built while
    walking the taps, and d_in an input row at a time from the reverse
    index (``sparse_max_pool_reader_plain`` where it is written, stale
    entries elsewhere: out of range, naming taps that read other rows, and
    naming the taps of invalid rows that do read the row), against the
    final-compare mask of ``sparse_max_pool_mask_plain`` and the tap-by-tap
    shares of ``sparse_max_pool_backward_plain``, bit for bit, on NaN,
    +-inf, +-0, absent taps, invalid rows, unread input rows and ties of 2
    to 8 taps."""
    x, nbr, ov, grad = walk_case(kind, dtype)
    out, mask = pool_walk(x, nbr, ov)
    want, want_mask = P.sparse_max_pool_mask_plain(x, nbr, ov)
    same_bits(out.float().numpy(), want.float().numpy())
    assert torch.equal(mask, want_mask)
    ties = {bin(v).count('1') for v in mask.unique().tolist()}
    if kind == 'ties':
        assert set(range(1, 9)) <= ties
    reader = P.sparse_max_pool_reader_plain(nbr, ov, x.shape[1])
    want_reader = torch.full(reader.shape, -1, dtype=torch.int32)
    for s, o, t in zip(*torch.nonzero((nbr >= 0) & ov[..., None],
                                      as_tuple=True)):
        want_reader[s, nbr[s, o, t]] = o * P.MAX_POOL_TAPS + t
    assert torch.equal(reader, want_reader)
    assert (reader >= 0).any() and (reader < 0).any()
    m_out = nbr.shape[1]
    stale = torch.from_numpy(np.random.RandomState(4).randint(
        -9, m_out * P.MAX_POOL_TAPS + 9, reader.shape).astype(np.int32))
    for s, o, t in zip(*torch.nonzero((nbr >= 0) & ~ov[..., None],
                                      as_tuple=True)):
        stale[s, nbr[s, o, t]] = o * P.MAX_POOL_TAPS + t
    d = pool_backward_walk(grad, torch.where(reader >= 0, reader, stale),
                           nbr, mask)
    want_d = P.sparse_max_pool_backward_plain(grad, nbr, mask, x.shape[1])
    same_bits(d.float().numpy(), want_d.float().numpy())


@pytest.mark.parametrize('route', ['plain', 'tiles', 'head'])
@pytest.mark.parametrize('fine_stride', [1, 2, 4])
def test_transposed_conv_equals_jax(level, fine_stride, route, monkeypatch):
    """The transposed conv onto the fine set.  ``head``: its table made up
    front, as ``FCAF3DHead.up_tables`` makes the up blocks' tables in one
    launch (here beside the coarse level's own up table), equal to
    ``transposed_table``'s and handed to the conv."""
    if route == 'tiles':
        route_through_tiles(monkeypatch)
    fine_c, fine_v = at_stride(level, fine_stride)
    coarse_c, coarse_v = P.downsample_coords(fine_c, fine_v, 2 * fine_stride,
                                             fine_c.shape[1] // 2)
    x, w = feats_of(coarse_v, 8, 6), weights(7, 2, 8, 16)
    want = J.transposed_conv_to_batched(
        jnp.asarray(fine_c.numpy()), jnp.asarray(fine_v.numpy()),
        jnp.asarray(coarse_c.numpy()), jnp.asarray(coarse_v.numpy()),
        jnp.asarray(x), jnp.asarray(w),
        tensor_stride=fine_stride, sorted_input=True, sorted_fine=True)
    tnbr = None
    if route == 'head':
        coarser = P.downsample_coords(coarse_c, coarse_v, 4 * fine_stride,
                                      coarse_c.shape[1] // 2)
        tnbr, up = FCAF3DHead.up_tables(
            [(fine_c, fine_v), (coarse_c, coarse_v), coarser],
            [fine_stride, 2 * fine_stride])
        assert torch.equal(tnbr, P.transposed_table(
            fine_c, fine_v, coarse_c, coarse_v, tensor_stride=fine_stride,
            sorted_input=True))
        assert torch.equal(up, P.transposed_table(
            coarse_c, coarse_v, *coarser, tensor_stride=2 * fine_stride,
            sorted_input=True))
    got = P.transposed_conv_to_batched(
        fine_c, fine_v, coarse_c, coarse_v, torch.from_numpy(x),
        torch.from_numpy(me_tap_order(w)), tensor_stride=fine_stride,
        sorted_input=True, nbr=tnbr)
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
