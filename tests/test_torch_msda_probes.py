"""The quad-plane MSDA route of the port and the plain versions of its
kernels (K5 row gather, K6 slot fold, K7 M-form sampler) against the JAX
package's Pallas kernels, run in interpret mode, and its XLA references,
on the same numpy inputs.  The kernels themselves are held against these
plain versions on the card (``test_torch_kernels.py``, ``chip_smoke.py``).

Bounds: the gathers are bit-equal.  The folds agree within 1e-5 of the
largest output in float32; with bf16 rows within 1e-2, because the JAX
fold rounds every product to bf16 and the port keeps it in float32.  The
M-form sampler agrees with the XLA reference within 1e-5 in float32, and
with the Pallas kernel within the probe's own rtol / atol of 0.05 in bf16
(that kernel sums its one-hot tile in bf16).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demf_tpu.ops.msda import _build_quad_plane, _geometry
from demf_tpu.ops.msda import multi_scale_deformable_attention as jmsda
from demf_tpu.ops.pallas.gather_rows import gather_rows as jgather_rows
from demf_tpu.ops.pallas.msda_fold import (weighted_slot_fold as jfold,
                                           weighted_slot_fold_batched as
                                           jfold_batched)
from demf_tpu_torch.ops import gather_rows, mform, msda, msda_fold, msda_quad

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools')
DTYPES = {'bf16': (jnp.bfloat16, torch.bfloat16),
          'f32': (jnp.float32, torch.float32)}
# a pyramid with a level 1 pixel high and one 1 pixel wide
SHAPES = ((6, 7), (3, 4), (1, 5), (2, 1))


def _pair(x, name):
    """The same values as a JAX and a torch array of dtype ``name`` (both
    round float32 to bf16 to nearest even)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_tool(monkeypatch, name):
    monkeypatch.syspath_prepend(TOOLS)
    return importlib.import_module(name)


@pytest.mark.parametrize('dtype', ['bf16', 'f32'])
def test_gather_rows_plain_matches_pallas(dtype):
    rng = np.random.RandomState(3)
    bh, n, s, c = 3, 999, 5000, 128
    jplane, plane = _pair(rng.randn(bh, n, c).astype(np.float32), dtype)
    idx = rng.randint(0, n, (bh, s)).astype(np.int32)
    got = gather_rows.gather_rows(plane, torch.from_numpy(idx))
    want = jgather_rows(jplane, jnp.asarray(idx), 4096, 4, True)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize('dtype', ['bf16', 'f32'])
def test_pallas_gather_probe_aligned(monkeypatch, dtype):
    probe = _jax_tool(monkeypatch, 'bench_gather_kernel')
    rng = np.random.RandomState(4)
    bh, n, s, c = 2, 1024, 4096, 128
    jplane, plane = _pair(rng.randn(bh, n, c).astype(np.float32), dtype)
    idx = rng.randint(0, n, (bh, s)).astype(np.int32)
    got = gather_rows.pallas_gather(plane, torch.from_numpy(idx))
    want = probe.pallas_gather(jplane, jnp.asarray(idx), 4096, 8, True)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_pallas_gather_unaligned_n_equals_fancy_indexing():
    """At N 999 the JAX probe ``pallas_gather`` reads wrong rows for
    indices in the last partial 16-row block (it does not pad N); the
    port has no blocks and equals fancy indexing."""
    rng = np.random.RandomState(5)
    bh, n, s, c = 2, 999, 4096, 128
    plane = rng.randn(bh, n, c).astype(np.float32)
    idx = rng.randint(0, n, (bh, s)).astype(np.int32)
    idx[:, :16] = np.arange(n - 16, n)
    got = gather_rows.pallas_gather(torch.from_numpy(plane),
                                    torch.from_numpy(idx))
    np.testing.assert_array_equal(
        got.numpy(), plane[np.arange(bh)[:, None], idx])


@pytest.mark.parametrize('dtype,bound', [('f32', 1e-5), ('bf16', 1e-2)])
@pytest.mark.parametrize('batched', [False, True])
def test_slot_fold_plain_matches_pallas(dtype, bound, batched):
    rng = np.random.RandomState(6)
    lead = (2,) if batched else ()
    lp, q, hd = 16, 300, 32
    jrows, rows = _pair(rng.randn(*lead, lp, q, 4 * hd).astype(np.float32),
                        dtype)
    w4 = rng.rand(*lead, lp, q, 4).astype(np.float32)
    if batched:
        got = msda_fold.weighted_slot_fold_batched(rows, torch.from_numpy(w4),
                                                   hd=hd)
        want = jfold_batched(jrows, jnp.asarray(w4), hd=hd, block=256,
                             interpret=True)
    else:
        got = msda_fold.weighted_slot_fold(rows, torch.from_numpy(w4), hd=hd)
        want = jfold(jrows, jnp.asarray(w4), hd=hd, block=256,
                     interpret=True)
    assert got.dtype == torch.float32
    assert _rel(got, want) < bound


@pytest.mark.parametrize('batched', [False, True])
def test_slot_major_fold_matches_main18_formula(batched):
    """main18's ``pallas_fold``: out[q, j] = sum_lp sum_s rows[lp, q,
    s*hd + j] * w[lp, s, q], the product in float32."""
    rng = np.random.RandomState(7)
    lead = (3,) if batched else ()
    lp, q, hd = 16, 200, 32
    rows = torch.from_numpy(rng.randn(*lead, lp, q, 4 * hd).astype(
        np.float32)).to(torch.bfloat16)
    w = rng.rand(*lead, lp, 4, q).astype(np.float32)
    got = msda_fold.slot_major_fold(rows, torch.from_numpy(w))
    r = rows.float().numpy().astype(np.float64).reshape(
        *lead, lp, q, 4, hd)
    want = np.einsum('...lqsj,...lsq->...qj', r, w.astype(np.float64))
    assert _rel(got, want) < 1e-5


def _mform_inputs(rng, bh, n, q, hd, nslots):
    plane = rng.randn(bh, n, hd).astype(np.float32)
    idx16 = rng.randint(0, n, (bh, nslots, q, 1)).astype(np.int32)
    w16 = rng.rand(bh, nslots, q, 1).astype(np.float32)
    return plane, idx16, w16


def test_mform_plain_matches_pallas_bf16(monkeypatch):
    probe = _jax_tool(monkeypatch, 'bench_msda_matmul')
    plane, idx16, w16 = _mform_inputs(np.random.RandomState(8), 2, 1024, 512,
                                      32, 16)
    jplane, tplane = _pair(plane, 'bf16')
    jw, tw = _pair(w16, 'bf16')
    got = mform.mform_sample(tplane, torch.from_numpy(idx16), tw)
    assert got.dtype == torch.bfloat16
    want = probe.mform_sample(jplane, jnp.asarray(idx16), jw, 256, 512, True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.05, atol=0.05)


def test_mform_plain_matches_xla_ref_f32(monkeypatch):
    probe = _jax_tool(monkeypatch, 'bench_msda_matmul')
    plane, idx16, w16 = _mform_inputs(np.random.RandomState(9), 3, 700, 300,
                                      32, 16)
    got = mform.mform_sample(*(torch.from_numpy(x)
                               for x in (plane, idx16, w16)))
    want = probe.xla_ref(*(jnp.asarray(x) for x in (plane, idx16, w16)))
    assert _rel(got, want) < 1e-5


def _msda_inputs(seed, b=2, q=50, heads=2, hd=8, p=2):
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in SHAPES)
    value = rng.randn(b, s, heads, hd).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (b, q, heads, len(SHAPES), p, 2)).astype(
        np.float32)
    aw = rng.rand(b, q, heads, len(SHAPES), p).astype(np.float32)
    aw /= aw.sum((-1, -2), keepdims=True)
    return value, locs, aw


def test_quad_plane_and_geometry_match_jax():
    value, locs, _ = _msda_inputs(10)
    got = msda_quad.build_quad_plane(torch.from_numpy(value), SHAPES)
    want = _build_quad_plane(jnp.asarray(value), SHAPES, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    geo = msda_quad.geometry(SHAPES, torch.from_numpy(locs))
    jgeo = _geometry(SHAPES, jnp.asarray(locs))
    np.testing.assert_array_equal(geo['idx'].numpy(), np.asarray(jgeo['idx']))
    assert geo['idx'].dtype == torch.int32
    for w, jw in zip(geo['ws'], jgeo['ws']):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize('query_chunk', [None, 16])
def test_msda_quad_forward_matches_jax_and_plain(monkeypatch, query_chunk):
    """The JAX op takes its quad route here (Q x L x P x 8 >= sum_HW), in
    one scan over slices, or query-chunked at query_chunk 16."""
    monkeypatch.setenv('DEMF_TPU_MSDA_F32', '1')
    value, locs, aw = _msda_inputs(11)
    got = msda_quad.msda_quad_forward(torch.from_numpy(value), SHAPES,
                                      torch.from_numpy(locs),
                                      torch.from_numpy(aw))
    want = jmsda(jnp.asarray(value), SHAPES, jnp.asarray(locs),
                 jnp.asarray(aw), query_chunk=query_chunk)
    assert _rel(got, want) < 1e-5
    plain = msda.msda_plain(torch.from_numpy(value), SHAPES,
                            torch.from_numpy(locs), torch.from_numpy(aw))
    assert _rel(got, plain) < 1e-5


@pytest.mark.parametrize('probe', ['bench_gather_kernel',
                                   'bench_msda_matmul', 'bench_msda_fold'])
def test_probes_refuse_to_run_without_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    tool = importlib.import_module(f'demf_tpu_torch.tools.{probe}')
    with pytest.raises(RuntimeError, match='needs an NVIDIA GPU'):
        tool.main([])
