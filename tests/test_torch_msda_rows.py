"""K4's row-owner route on the CPU (``ops/msda.py::msda_row_entries`` and
``msda_backward_rows_plain``: the corner entries, sorted by row and summed
a row at a time in float32, rounded once), which ``csrc/msda_backward.cu``
implements for a bfloat16 and a float32 value at the decoders' shapes.  At
a small decoder shape (B 2, Q 16, 2 heads, hd 8, 2 levels, P 2) its d_value
is held against the autograd of ``msda_plain`` (float32: 1e-5 of the
largest; a bfloat16 value: one bf16 step of the largest, 2^-7, where the
two float32 sums straddle a rounding boundary) and against ``jax.vjp`` of
the JAX package's small-Q MSDA (``_make_small_q_msda``): on a float32 value
with float32 gather planes 1e-5 of the largest; on a bfloat16 value with
float32 planes one bf16 step of the largest, with its bf16 planes (the
policy's default, which round the products) the 2e-2 of
``tests/test_torch_precision.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.ops import msda as jmsda
from demf_tpu_torch.ops import msda

SHAPES = ((6, 8), (3, 4))
B, Q, HEADS, HD, P = 2, 16, 2, 8, 2
BF16_STEP = 2.0 ** -7


def inputs(seed=0, spread=1.2):
    """value (B, S, heads, hd), locations over and around the map, weights,
    grad_out (B, Q, heads * hd), float32 numpy."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES)
    value = rng.randn(B, s, HEADS, HD).astype(np.float32)
    locs = (rng.rand(B, Q, HEADS, len(SHAPES), P, 2) * spread -
            (spread - 1) / 2).astype(np.float32)
    aw = rng.rand(B, Q, HEADS, len(SHAPES), P).astype(np.float32)
    grad = rng.randn(B, Q, HEADS * HD).astype(np.float32)
    return value, locs, aw, grad


def autograd_d_value(value, locs, aw, grad):
    v = value.clone().requires_grad_()
    out = msda.msda_plain(v, SHAPES, locs, aw)
    (d_value,) = torch.autograd.grad(out, [v], grad.to(out.dtype))
    return d_value


def within(got, want, rel_max):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) <= rel_max * float(
        want.abs().max())


def test_entries_are_the_corners_in_index_order():
    """Entry ((l * Q + q) * P + p) * 4 + 2 * dy + dx is corner (dy, dx) of
    that sample: its token row, or sum_HW off the map, and weight a * w_x *
    w_y; the weights of a sample's corners on the map sum to a."""
    value, locs, aw, _ = inputs(spread=1.6)
    rows, weights = msda.msda_row_entries(SHAPES, torch.from_numpy(locs),
                                          torch.from_numpy(aw))
    s = value.shape[1]
    assert rows.shape == weights.shape == (B, HEADS, Q * len(SHAPES) * P * 4)
    assert rows.dtype == torch.int64 and weights.dtype == torch.float32
    assert ((rows >= 0) & (rows <= s)).all() and (rows == s).any()
    assert (weights[rows == s] == 0).all()
    b, h, q, l, p = 1, 1, 5, 1, 1
    e = ((l * Q + q) * P + p) * 4
    hl, wl = SHAPES[l]
    x = float(locs[b, q, h, l, p, 0]) * wl - 0.5
    y = float(locs[b, q, h, l, p, 1]) * hl - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    for k in range(4):
        yi, xi = y0 + k // 2, x0 + k % 2
        on = 0 <= xi < wl and 0 <= yi < hl
        assert int(rows[b, h, e + k]) == (SHAPES[0][0] * SHAPES[0][1] +
                                          yi * wl + xi if on else s)
    sums = weights.view(B, HEADS, len(SHAPES), Q, P, 4).sum(-1)
    inside = (rows.view(B, HEADS, len(SHAPES), Q, P, 4) < s).all(-1)
    a = torch.from_numpy(aw).permute(0, 2, 3, 1, 4)
    assert torch.allclose(sums[inside], a[inside], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('spread', [1.0, 1.6, 'piled'])
def test_row_order_d_value_equals_the_plain_autograd(dtype, spread):
    """Locations over the map, over and around it, and every sample piled
    on one place (four rows a level take every corner: lists of Q * P)."""
    value, locs, aw, grad = (torch.from_numpy(a) for a in inputs(
        1, 1.0 if spread == 'piled' else spread))
    if spread == 'piled':
        locs[:] = torch.tensor([0.43, 0.61])
    value, grad = value.to(dtype), grad.to(dtype)
    got = msda.msda_backward_rows_plain(value, SHAPES, locs, aw, grad)
    assert got.dtype == dtype and got.shape == value.shape
    want = autograd_d_value(value, locs, aw, grad)
    assert within(got, want, 1e-5 if dtype == torch.float32 else BF16_STEP)
    again = msda.msda_backward_rows_plain(value, SHAPES, locs, aw, grad)
    assert torch.equal(got, again)


def test_row_order_sums_a_row_in_the_order_of_its_entries():
    """Every sample at one place: every query's corners land on the same
    four rows, whose sums are taken one entry after another in index
    order, as the kernel takes them."""
    value, locs, aw, grad = (torch.from_numpy(a) for a in inputs(2))
    locs[:] = torch.tensor([0.43, 0.61])
    got = msda.msda_backward_rows_plain(value, SHAPES, locs, aw, grad)
    rows, weights = msda.msda_row_entries(SHAPES, locs, aw)
    g = grad.view(B, Q, HEADS, HD)
    b, h = 1, 0
    row = int(rows[b, h, 0])
    want = torch.zeros(HD)
    for i in torch.nonzero(rows[b, h] == row)[:, 0].tolist():
        want = want + weights[b, h, i] * g[b, i % (Q * P * 4) // (P * 4), h]
    assert torch.equal(got[b, row, h], want)


@pytest.mark.parametrize('gather,dtype', [
    pytest.param('float32', 'bfloat16', id='float32'),
    pytest.param('bfloat16', 'bfloat16', id='bfloat16'),
    pytest.param('float32', 'float32', id='float32 value')])
def test_row_order_d_value_matches_jax_small_q_vjp(gather, dtype):
    """The JAX package's small-Q MSDA (the decoder's route) on a bf16 or a
    float32 value, its d_value by ``jax.vjp``."""
    value, locs, aw, grad = inputs(3)
    fn = jmsda._make_small_q_msda(SHAPES, gather)
    _, vjp = jax.vjp(fn, jnp.asarray(value, dtype), jnp.asarray(locs),
                     jnp.asarray(aw))
    want = vjp(jnp.asarray(grad, dtype))[0]
    assert want.dtype == jnp.dtype(dtype)
    to = getattr(torch, dtype)
    got = msda.msda_backward_rows_plain(
        torch.from_numpy(value).to(to), SHAPES, torch.from_numpy(locs),
        torch.from_numpy(aw), torch.from_numpy(grad).to(to))
    assert got.dtype == to
    bound = (1e-5 if dtype == 'float32' else
             BF16_STEP if gather == 'float32' else 2e-2)
    assert within(got, torch.from_numpy(np.asarray(want, np.float32)), bound)


# (Q, levels, P, head_dim, fits in bfloat16, fits in float32)
ROUTE_CASES = [(256, 4, 2, 32, True, True), (300, 4, 4, 32, True, True),
               (1408, 4, 4, 32, True, False), (1409, 4, 4, 32, False, False),
               (256, 4, 2, 4, False, True), (256, 3, 2, 32, False, False),
               (22323, 4, 4, 32, False, False)]


@pytest.mark.parametrize('q,levels,points,hd,fits,dtype', [
    pytest.param(q, levels, points, hd, fits, torch.bfloat16,
                 id=f'{q}-{levels}-{points}-{hd}-{fits}')
    for q, levels, points, hd, fits, _ in ROUTE_CASES] + [
    pytest.param(q, levels, points, hd, fits, torch.float32,
                 id=f'{q}-{levels}-{points}-{hd}-{fits}-float32')
    for q, levels, points, hd, _, fits in ROUTE_CASES])
def test_rows_route_takes_the_decoders_shapes(q, levels, points, hd, fits,
                                              dtype):
    """The stage-2 decoder (Q 256, P 2) and the pretrain decoder (Q 300, P
    4) take the route, the largest level's 16,800 rows given to the kernel;
    more than 22,528 entries a (scene, head, level), levels that are not
    the shapes', or the encoder's one query a token do not.  In bfloat16 a
    head_dim that is not a multiple of 8 and a token row wider than 2,048
    channels do not either (a token row's threads, 8 channels each, in one
    block); in float32 a head_dim that is a multiple of 4 does, with any
    number of heads (a block a head and a slice of a level's rows), while
    the head's grad_out rows, a slice's row counts and the entries fit a
    block's shared memory (at Q 1,408, P 4 they do not).  The scratch: 16
    bytes an entry in bfloat16 (keys and weights, then the sorted pairs)
    and 2 a row and level of each (scene, head); none in float32."""
    shapes = ((100, 168), (50, 84), (25, 42), (13, 21))
    assert msda.msda_rows_route(shapes, q, 8, levels, points, hd, dtype) == (
        16800 if fits else 0)
    at_32 = msda.msda_rows_route(shapes, q, 8, levels, points, 32, dtype)
    if dtype == torch.bfloat16:
        assert msda.msda_rows_route(shapes, q, 64, levels, points, 32,
                                    dtype) == at_32
        assert not msda.msda_rows_route(shapes, q, 65, levels, points, 32,
                                        dtype)
        assert msda.msda_rows_scratch_bytes(16, 22323, 256, 8, 4, 2,
                                            dtype) == \
            16 * 16 * 8 * 4 * 256 * 2 * 4 + 2 * 16 * 8 * (22323 + 4)
    else:
        assert msda.msda_rows_route(shapes, q, 65, levels, points, 32,
                                    dtype) == at_32
        assert msda.msda_rows_scratch_bytes(16, 22323, 256, 8, 4, 2,
                                            dtype) == 0
        # a block a slice of at most 2,048 rows: 9 + 3 + 1 + 1
        assert msda.msda_lists_parts(shapes) == 14
