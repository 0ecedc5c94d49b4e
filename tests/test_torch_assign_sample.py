"""The port's 2D assigner and sampler (``demf_tpu_torch/models/
assign_sample.py``) against the JAX package's, on the CPU.

* ``iou_2d`` within 1e-6 on boxes that overlap, nest, touch, miss and are
  empty;
* ``max_iou_assign`` codes equal, with and without the low-quality
  matches, with invalid GT slots, anchors of equal IoU (duplicated
  anchors, a GT whose best IoU two anchors share, an anchor two GT claim:
  the last claimant wins), and the JAX tests' semantics case;
* ``random_sample`` masks equal on the same uniforms: the JAX side's keys
  split per image as ``rpn_loss`` splits them, each image's into the
  positive and the negative key, the draws handed to the port; ties of the
  keys go to the lower index on both sides; and the JAX tests' counts.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.models import assign_sample as jas
from demf_tpu_torch.models import assign_sample as pas


def random_boxes(rng, n, extent=100.0):
    xy = rng.uniform(-10, extent, (n, 2))
    wh = rng.uniform(0, extent / 2, (n, 2))
    wh[::7] = 0.0                                  # empty boxes
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def sample_draws(key, n):
    """The positive and the negative uniforms ``random_sample`` draws from
    ``key`` over ``n`` anchors."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


def test_iou_2d_matches_jax():
    rng = np.random.RandomState(0)
    a = random_boxes(rng, 300)
    b = random_boxes(rng, 20)
    b[0] = a[3]                                    # identical
    b[1] = [a[5, 0] + 1, a[5, 1] + 1, a[5, 2] - 1, a[5, 3] - 1]   # nested
    b[2] = [a[8, 2], a[8, 1], a[8, 2] + 5, a[8, 3]]   # touching
    want = np.asarray(jas.iou_2d(jnp.asarray(a), jnp.asarray(b)))
    got = pas.iou_2d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (300, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # batched: each image's matrix, and anchors shared across images
    bb = np.stack([b, b[::-1].copy()])
    got_b = pas.iou_2d(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    np.testing.assert_allclose(got_b[1], np.asarray(jas.iou_2d(
        jnp.asarray(a), jnp.asarray(bb[1]))), rtol=0, atol=1e-6)


def assign_case(kind, rng):
    """(anchors, gt, gt_valid) of a named case."""
    a = random_boxes(rng, 200, 60.0)
    g = random_boxes(rng, 8, 60.0) + np.array([0, 0, 4, 4], np.float32)
    a[160:168] = g + rng.uniform(-1, 1, g.shape).astype(np.float32)
    valid = np.ones(8, bool)
    if kind == 'invalid_slots':
        valid[[2, 5, 7]] = False
    elif kind == 'duplicated_anchors':
        a[100:150] = a[0:50]                       # equal IoU, other index
        g[1] = a[10]
    elif kind == 'shared_claims':
        g[4] = g[2]                                # two GT, one best anchor
        a[30] = g[2]
        a[31] = g[2]
    return a, g, valid


@pytest.mark.parametrize('low_quality', [True, False])
@pytest.mark.parametrize('kind', ['random', 'invalid_slots',
                                  'duplicated_anchors', 'shared_claims'])
def test_max_iou_assign_matches_jax(kind, low_quality):
    a, g, valid = assign_case(kind, np.random.RandomState(len(kind)))
    jious = jas.iou_2d(jnp.asarray(a), jnp.asarray(g))
    want = np.asarray(jas.max_iou_assign(jious, jnp.asarray(valid), 0.7, 0.3,
                                         0.3, low_quality))
    got = pas.max_iou_assign(pas.iou_2d(torch.from_numpy(a),
                                        torch.from_numpy(g)),
                             torch.from_numpy(valid), 0.7, 0.3, 0.3,
                             low_quality).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() and (want == -1).any()
    if kind == 'shared_claims' and low_quality:
        assert got[30] == got[31] == 4             # the last claimant


def test_max_iou_assign_semantics():
    """The JAX tests' case (tests/test_rpn_roi.py), on the port."""
    anchors = torch.tensor([[0, 0, 10, 10], [0, 0, 9, 9], [50, 50, 60, 60],
                            [100, 100, 101, 101]], dtype=torch.float32)
    gt = torch.tensor([[0, 0, 10, 10], [52, 52, 58, 58]],
                      dtype=torch.float32)
    out = pas.max_iou_assign(pas.iou_2d(anchors, gt),
                             torch.ones(2, dtype=bool), 0.7, 0.3, 0.3, True)
    assert out.tolist() == [0, 0, 1, -1]


@pytest.mark.parametrize('num,fraction,n_pos,n_neg', [
    (32, 0.5, 10, 100),      # every positive, negatives fill
    (16, 0.25, 40, 30),      # positives capped
    (64, 0.5, 3, 20),        # fewer samples than num
    (8, 0.5, 0, 50),         # no positive
])
def test_random_sample_matches_jax(num, fraction, n_pos, n_neg):
    """Two images, each with its own key as ``jax.random.split`` gives
    them: the masks equal."""
    rng = np.random.RandomState(num)
    n = n_pos + n_neg + 25
    assigned = np.full((2, n), -2, np.int32)
    for i in range(2):
        idx = rng.permutation(n)
        assigned[i, idx[:n_pos]] = rng.randint(0, 4, n_pos)
        assigned[i, idx[n_pos:n_pos + n_neg]] = -1
    keys = jax.random.split(jax.random.PRNGKey(num), 2)
    want = jax.vmap(lambda a, k: jas.random_sample(a, num, fraction, k))(
        jnp.asarray(assigned), keys)
    draws = [sample_draws(k, n) for k in keys]
    got = pas.random_sample(
        torch.from_numpy(assigned).long(), num, fraction,
        u_pos=torch.from_numpy(np.stack([d[0] for d in draws])),
        u_neg=torch.from_numpy(np.stack([d[1] for d in draws])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos, neg = (g.numpy() for g in got)
    assert not (pos & neg).any()
    assert (pos.sum(1) <= int(num * fraction)).all()
    assert ((pos | neg).sum(1) <= num).all()


def test_random_sample_ties_go_to_the_lower_index():
    """Keys of equal value: ``jax.lax.top_k`` takes the lower index first,
    and so does the port's stable top-k."""
    assigned = np.array([0] * 6 + [-1] * 10, np.int32)
    u = np.full(16, 0.5, np.float32)
    u[[1, 4]] = 0.9
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jas.jax.random, 'uniform', lambda key, shape: jnp.asarray(
            u[:shape[0]]))
        want = jas.random_sample(jnp.asarray(assigned), 8, 0.25,
                                 jax.random.PRNGKey(0))
    got = pas.random_sample(torch.from_numpy(assigned).long(), 8, 0.25,
                            u_pos=torch.from_numpy(u),
                            u_neg=torch.from_numpy(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].nonzero().flatten().tolist() == [1, 4]
    assert got[1].nonzero().flatten().tolist() == list(range(6, 12))


def test_random_sample_counts():
    """The JAX tests' case (tests/test_rpn_roi.py), on the port's own
    draws: all 10 positives (under the cap of 16), negatives to 32, none
    of the ignored."""
    assigned = torch.tensor([0] * 10 + [-1] * 100 + [-2] * 20)
    pos, neg = pas.random_sample(assigned, 32, 0.5,
                                 torch.Generator().manual_seed(0))
    assert int(pos.sum()) == 10 and int(neg.sum()) == 22
    assert not (pos & neg).any()
    assert not pos[110:].any() and not neg[110:].any()
