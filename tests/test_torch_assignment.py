"""The port's DETR matchers against the JAX package's, on the CPU.

``ops/assignment.py::auction_match`` takes the same steps as the JAX
auction (ties to the lowest index on both sides), so on seeded costs the
assignments are equal index for index, padding rows included; continuous
random costs have no ties between real entries, and the uniform padding
rows tie everywhere, which is what holds the tie rule.  Its total cost lies
within ``G * eps`` of scipy's optimum (eps = 0.002 of the real cost range
over G).  The two precision pitfalls of the JAX module's docstring are held
here too: the epsilon scale from real entries only, and the sentinel
clamped to unit scale.  ``hungarian_match`` equals the JAX host path.
"""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from demf_tpu.models.detr_head import hungarian_match as jax_hungarian_match
from demf_tpu.ops.assignment import auction_match as jax_auction_match
from demf_tpu_torch.ops.assignment import (auction_assign, auction_match,
                                           hungarian_match)


def _costs(seed, b, q, g, real, scale=1.0):
    """(B, Q, G) costs; gt columns from ``real[i]`` on are padding (1e6)."""
    rng = np.random.RandomState(seed)
    cost = (rng.rand(b, q, g) * scale).astype(np.float32)
    for i, r in enumerate(real):
        cost[i, :, r:] = 1e6
    return cost


def _optimum(cost_qg, real):
    row, col = linear_sum_assignment(cost_qg[:, :real].T)
    return cost_qg[:, :real].T[row, col].sum()


CASES = [
    # seed, B, Q, G, real gt of each image, cost scale
    (0, 3, 20, 8, (8, 5, 1), 1.0),          # the tiny config's shape
    (1, 2, 64, 16, (6, 16), 5.0),
    (2, 4, 300, 20, (20, 17, 3, 12), 10.0),  # the full model's shape
    (3, 2, 5, 5, (5, 4), 1.0),              # G = Q
    (4, 2, 32, 8, (0, 0), 1.0),             # all rows padding
    (5, 1, 64, 32, (16,), 1.0),             # the epsilon-scale scenario
]


@pytest.mark.parametrize('seed,b,q,g,real,scale', CASES)
def test_auction_match_equals_jax(seed, b, q, g, real, scale):
    cost = _costs(seed, b, q, g, real, scale)
    got = auction_match(torch.from_numpy(cost))
    want = np.asarray(jax_auction_match(jnp.asarray(cost)))
    assert got.dtype == torch.int64 and tuple(got.shape) == (b, g)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(b):
        assert len(set(got[i].tolist())) == g      # distinct queries


@pytest.mark.parametrize('seed,b,q,g,real,scale', CASES)
def test_auction_total_cost_within_eps_of_scipy(seed, b, q, g, real, scale):
    cost = _costs(seed, b, q, g, real, scale)
    got = auction_match(torch.from_numpy(cost)).numpy()
    for i, r in enumerate(real):
        if r == 0:
            continue
        total = cost[i][got[i, :r], np.arange(r)].sum()
        entries = cost[i][:, :r]
        bound = 0.002 * max(entries.max() - entries.min(), 1e-6)
        assert total <= _optimum(cost[i], r) + bound + 1e-5, (i, total)


@pytest.mark.parametrize('seed', range(4))
def test_epsilon_scale_comes_from_real_entries(seed):
    """With eps from the full range the 1e6 sentinel would make the solve
    greedy (up to 9% over scipy); it must stay within 0.1%."""
    cost = _costs(seed, 1, 64, 32, (16,))
    got = auction_match(torch.from_numpy(cost)).numpy()[0]
    total = cost[0][got[:16], np.arange(16)].sum()
    assert total <= _optimum(cost[0], 16) * 1.001 + 1e-4


def test_sentinel_is_clamped_to_unit_scale():
    """Nets at the 1e6 scale quantize at ~0.06 in float32; the real rows'
    assignment must not depend on how large the sentinel is."""
    base = _costs(7, 2, 64, 16, (9, 4))
    big = base.copy()
    big[base >= 1e5] = 1e9
    a = auction_match(torch.from_numpy(base)).numpy()
    b = auction_match(torch.from_numpy(big)).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('check_every', [1, 3, 8, 64])
def test_convergence_check_interval_changes_nothing(check_every):
    """A step is the identity once every row is assigned, so reading the
    state on the host less often gives the same assignment."""
    cost = torch.from_numpy(_costs(8, 3, 40, 12, (12, 7, 2))).transpose(1, 2)
    want, steps = auction_assign(cost, check_every=1, return_steps=True)
    got, ran = auction_assign(cost, check_every=check_every,
                              return_steps=True)
    assert torch.equal(got, want)
    assert steps <= ran < steps + check_every


def test_max_iters_fallback_is_well_formed():
    cost = torch.from_numpy(_costs(9, 2, 30, 10, (10, 6))).transpose(1, 2)
    got = auction_assign(cost, max_iters=2)
    assert tuple(got.shape) == (2, 10)
    assert int(got.min()) >= 0 and int(got.max()) < 30


@pytest.mark.parametrize('seed,b,q,g,real,scale', CASES[:4])
def test_hungarian_match_equals_jax_host_path(seed, b, q, g, real, scale):
    cost = _costs(seed, b, q, g, real, scale)
    got = hungarian_match(torch.from_numpy(cost))
    want = np.asarray(jax_hungarian_match(jnp.asarray(cost)))
    np.testing.assert_array_equal(got.numpy(), want)
