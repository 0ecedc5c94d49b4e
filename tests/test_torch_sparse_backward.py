"""The backward of the port's sparse convolution (``ops/sparse.py``:
``SparseConv``, its reverse tables and ``sparse_conv_dweights``, K16's
plain version) against ``jax.vjp`` of the JAX package's convolutions, on
the CPU, on the same inputs made with numpy from a seed.

* d_feats and d_weights of each table kind: the submanifold 27-tap conv
  (``_conv_sym``: the table flipped), the strided 2x2x2 conv and the
  stem's strided 3x3x3 (``_conv_revgeo``), the stride-2 shortcut (tap 0 of
  the strided table; JAX's one-tap ``rev``) and the transposed conv (its
  reverse made anew, or the backbone's strided table between the two
  levels), within 1e-5 of each gradient's largest; the d_feats of padding
  rows exactly 0;
* the submanifold and strided kinds in bfloat16 (the bf16 policy's rows,
  weights and output gradient) against ``jax.vjp`` of the same functions
  on the same bf16 inputs.  The JAX package sums each tap into a bf16
  accumulator (``_conv_scan_math``, forward and d_feats), the port in
  float32 rounded once, so the output and d_feats are held to the JAX
  package's own bf16 - float32 gap (JAX's bf16 result against its float32
  one on the unrounded inputs): within twice it of JAX's bf16 result (seen
  at most 1.13 of it; the strided conv's d_feats, one tap a row, equal).  d_weights is a float32 sum of exact products rounded
  to bf16 in both packages: within 2^-8 of its largest (seen equal);
* every tap order of a centred cube centrally symmetric (why a flipped
  table is the reverse);
* the transposed conv's reverse equal to the strided conv's table;
* K16's plain version against the JAX package's ``_conv_dweights``, and
  ``gradcheck`` of the Function in float64 (the plain route);
* the backward takes the plain versions on the CPU and never autograd of
  the plain forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.ops import sparse as J
from demf_tpu_torch.engine.weights import me_tap_order
from demf_tpu_torch.ops import sparse as P
from test_torch_sparse import at_stride, cloud, feats_of, port_voxels, weights

KINDS = ('submanifold', 'strided', 'stem', 'shortcut', 'transposed',
         'transposed_strided_table')


@pytest.fixture(scope='module')
def level():
    """A scene pair's voxel tables (capacity 512, about 330 voxels each
    within 1.8 m, 3 taps a row on average)."""
    pts, feats = cloud(0, n=600, hi=1.5)
    return port_voxels(pts, feats, 512)


def jnp_(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def rel(got, want):
    want = np.asarray(want)
    return np.abs(got.detach().numpy() - want).max() / max(
        np.abs(want).max(), 1e-30)


def case(level, kind, stride):
    """(JAX function of (x, w), port function of (x, w), x, w in JAX's tap
    order, the input rows' valid mask, the kernel size)."""
    coords, valid = at_stride(level, stride)
    jc, jv = jnp_(coords), jnp_(valid)
    if kind == 'submanifold':
        x, w = feats_of(valid, 8, 1), weights(2, 3, 8, 16)
        return (lambda xx, ww: J.submanifold_conv_batched(
            jc, jv, xx, ww, tensor_stride=stride, sorted_input=True),
            lambda xx, ww: P.submanifold_conv_batched(
                coords, valid, xx, ww, tensor_stride=stride,
                sorted_input=True), x, w, valid, 3)
    if kind in ('strided', 'stem'):
        k = 2 if kind == 'strided' else 3
        x, w = feats_of(valid, 8, 3), weights(4, k, 8, 16)
        return (lambda xx, ww: J.strided_conv_batched(
            jc, jv, xx, ww, kernel_size=k, max_out=256,
            tensor_stride=stride, sorted_input=True)[2],
            lambda xx, ww: P.strided_conv_batched(
                coords, valid, xx, ww, kernel_size=k, max_out=256,
                tensor_stride=stride, sorted_input=True)[2], x, w, valid, k)
    if kind == 'shortcut':
        oc, ov = P.downsample_coords(coords, valid, 2 * stride, 256)
        nbr_s = P.kernel_tables([P.TableJob(coords, valid, oc, ov, 2, True,
                                            stride)])[0]
        jnbr = J.neighbor_table_batched(jc, jv, jnp_(oc), jnp_(ov),
                                        J.kernel_offsets(1), in_stride=stride,
                                        sorted_input=True)
        rev = dict(kernel_size=1, in_stride=stride, out_coords=jnp_(oc),
                   out_valid=jnp_(ov), in_coords=jc, in_valid=jv,
                   sorted_out=True)
        x, w = feats_of(valid, 8, 5), weights(6, 1, 8, 16)
        return (lambda xx, ww: J.sparse_conv_apply_batched(xx, jnbr, ww,
                                                           rev=rev),
                lambda xx, ww: P.sparse_conv_apply_batched(
                    xx, nbr_s[..., :1], ww, rev=P.strided_reverse(
                        coords, valid, oc, ov, 2, 2, stride).taps(1)),
                x, w, valid, 1)
    # transposed: coarse rows (the input) onto the fine level
    cc, cv = P.downsample_coords(coords, valid, 2 * stride,
                                 coords.shape[1] // 2)
    x, w = feats_of(cv, 8, 6), weights(7, 2, 8, 16)
    rev = None
    if kind == 'transposed_strided_table':
        table = P.kernel_tables([P.TableJob(coords, valid, cc, cv, 2, True,
                                            stride)])[0]
        rev = P.Reverse.of(table, None)
    return (lambda xx, ww: J.transposed_conv_to_batched(
        jc, jv, jnp_(cc), jnp_(cv), xx, ww, tensor_stride=stride,
        sorted_input=True, sorted_fine=True),
        lambda xx, ww: P.transposed_conv_to_batched(
            coords, valid, cc, cv, xx, ww, tensor_stride=stride,
            sorted_input=True, rev=rev), x, w, cv, 2)


def jax_vjp(jfn, x, w, dtype):
    """JAX's output, d_feats and d_weights in float32 numpy, from x, w and
    the cotangent (the same seed) cast to ``dtype``."""
    out, vjp = jax.vjp(jfn, jnp.asarray(x).astype(dtype),
                       jnp.asarray(w).astype(dtype))
    ct = np.random.RandomState(11).randn(*out.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(ct).astype(dtype))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (out, dx, dw)) + (
        ct,)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('kind,dtype', [
    *(pytest.param(k, 'float32', id=k) for k in KINDS),
    *(pytest.param(k, 'bfloat16', id=f'{k}-bf16')
      for k in ('submanifold', 'strided'))])
def test_backward_equals_jax_vjp(level, kind, dtype, stride):
    jfn, pfn, x, w, in_valid, k = case(level, kind, stride)
    out, dx, dw, ct = jax_vjp(jfn, x, w, dtype)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(me_tap_order(w) if k > 1 else w).to(
        tdt).requires_grad_()
    got = pfn(xt, wt)
    got.backward(torch.from_numpy(ct).to(tdt))
    assert got.dtype == xt.grad.dtype == wt.grad.dtype == tdt
    got, gx, gw = (t.detach().float() for t in (got, xt.grad, wt.grad))
    dw_ = me_tap_order(dw) if k > 1 else dw
    if dtype == 'float32':
        assert rel(got, out) <= 1e-5
        assert rel(gx, dx) <= 1e-5, rel(gx, dx)
        assert rel(gw, dw_) <= 1e-5
    else:
        out32, dx32, _, _ = jax_vjp(jfn, x, w, 'float32')
        for name, mine, want, ref in (('out', got, out, out32),
                                      ('d_feats', gx, dx, dx32)):
            gap = np.abs(want - ref).max() / np.abs(ref).max()
            assert rel(mine, want) <= 2 * gap, (name, rel(mine, want), gap)
        assert rel(gw, dw_) <= 2 ** -8
    assert (gx[~in_valid] == 0).all()
    assert np.abs(dx).max() > 0 and np.abs(dw).max() > 0


@pytest.mark.parametrize('me_order', [True, False])
@pytest.mark.parametrize('k', [1, 3, 5])
def test_centred_cube_is_centrally_symmetric(k, me_order):
    offs = P.kernel_offsets(k, me_order=me_order)
    assert torch.equal(offs.flip(0), -offs)


@pytest.mark.parametrize('stride', [1, 2, 4])
def test_transposed_reverse_is_the_strided_table(level, stride):
    """The reverse of the transposed conv from level s to the finer level
    is the strided conv's table between them, which MinkResNet makes in its
    forward: the head hands it over and the backward makes none."""
    coords, valid = at_stride(level, stride)
    cc, cv = P.downsample_coords(coords, valid, 2 * stride,
                                 coords.shape[1] // 2)
    strided = P.strided_conv_batched(
        coords, valid, torch.zeros(*valid.shape, 1), torch.zeros(8, 1, 1),
        kernel_size=2, max_out=coords.shape[1] // 2, tensor_stride=stride,
        sorted_input=True)[3]
    rev = P.transposed_reverse(coords, valid, cc, cv, 2, stride)()[0]
    assert torch.equal(rev, strided)
    # and the strided conv's reverse is the transposed conv's table
    up = P.transposed_table(coords, valid, cc, cv, tensor_stride=stride,
                            sorted_input=True)
    assert torch.equal(P.strided_reverse(coords, valid, cc, cv, 2, 2,
                                         stride)()[0], up)


@pytest.mark.parametrize('kind', ['submanifold', 'strided'])
def test_dweights_plain_equals_jax(level, kind):
    coords, valid = at_stride(level, 2)
    if kind == 'submanifold':
        nbr = P.submanifold_table(coords, valid, 3, 2)
    else:
        oc, ov = P.downsample_coords(coords, valid, 4, 256)
        nbr = P.kernel_tables([P.TableJob(coords, valid, oc, ov, 2, True,
                                          2)])[0]
    x = feats_of(valid, 8, 8)
    g = np.random.RandomState(9).randn(*nbr.shape[:2], 16).astype(
        np.float32)
    want = J._conv_dweights(jnp.asarray(x), jnp_(nbr), jnp.asarray(g))
    got = P.sparse_conv_dweights(torch.from_numpy(x), nbr,
                                 torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (nbr.shape[2], 8, 16)
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize('kind', ['submanifold', 'strided', 'transposed'])
def test_gradcheck_float64(kind):
    """The Function's backward (plain route) against finite differences in
    float64, on a small level (24 points within 1 m: neighbours at 10 cm
    voxels, and some rows with none)."""
    pts, feats = cloud(2, b=2, n=24, hi=1.0)
    coords, _, valid = port_voxels(pts, feats, 24)
    torch.manual_seed(0)
    if kind == 'transposed':
        cc, cv = P.downsample_coords(coords, valid, 2, 12)
        x = torch.randn(2, 12, 2, dtype=torch.float64) * cv[..., None]
        w = torch.randn(8, 2, 2, dtype=torch.float64)

        def fn(xx, ww):
            return P.transposed_conv_to_batched(coords, valid, cc, cv, xx,
                                                ww, sorted_input=True)
    else:
        x = torch.randn(2, 24, 2, dtype=torch.float64) * valid[..., None]
        if kind == 'submanifold':
            w = torch.randn(27, 2, 2, dtype=torch.float64)

            def fn(xx, ww):
                return P.submanifold_conv_batched(coords, valid, xx, ww,
                                                  sorted_input=True)
        else:
            w = torch.randn(8, 2, 2, dtype=torch.float64)

            def fn(xx, ww):
                return P.strided_conv_batched(coords, valid, xx, ww,
                                              max_out=12,
                                              sorted_input=True)[2]
    assert torch.autograd.gradcheck(fn, (x.requires_grad_(),
                                         w.requires_grad_()))


def test_backward_takes_the_plain_versions(level, monkeypatch):
    """On the CPU the backward runs ``sparse_conv_plain`` on the reverse
    table and ``sparse_conv_dweights_plain``; a reverse table is made once
    however many convolutions share it; the stem's colours (no gradient)
    ask for d_weights only."""
    coords, valid = at_stride(level, 1)
    nbr = P.submanifold_table(coords, valid, 3, 1)
    made = []
    rev = P.Reverse(lambda: made.append(1) or nbr.flip(-1))
    calls = {'plain': 0, 'dweights': 0}
    plain, dweights = P.sparse_conv_plain, P.sparse_conv_dweights_plain

    def count(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(P, 'sparse_conv_plain', count('plain', plain))
    monkeypatch.setattr(P, 'sparse_conv_dweights_plain',
                        count('dweights', dweights))
    x = torch.from_numpy(feats_of(valid, 4, 1)).requires_grad_()
    w = [torch.from_numpy(weights(s, 3, 4, 4)).requires_grad_()
         for s in (1, 2)]
    y = P.submanifold_conv_batched(coords, valid, x, w[0], nbr=nbr, rev=rev)
    y = P.submanifold_conv_batched(coords, valid, y, w[1], nbr=nbr, rev=rev)
    y.sum().backward()
    assert made == [1]
    assert calls == {'plain': 4, 'dweights': 2}
    colours = torch.from_numpy(feats_of(valid, 4, 2))
    calls.update(plain=0, dweights=0)
    P.submanifold_conv_batched(coords, valid, colours, w[0], nbr=nbr,
                               rev=rev).sum().backward()
    assert calls == {'plain': 1, 'dweights': 1}
