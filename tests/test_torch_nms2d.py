"""The port's 2D NMS (``demf_tpu_torch/ops/nms2d.py``) against the JAX
package's ``batched_nms_2d`` / ``nms_2d``, on the CPU: keep masks equal,
on both of the JAX package's branches (the IoU matrix at N <= 4096 and the
row-wise loop above), with 1, 5 and 10 groups, tied scores, invalid
entries, zero-area and identical boxes; and K10's rule in plain Python
(``batched_nms_2d_tiled``: the order by group, 64-bit words of 64x64
tiles, a sweep a group) against the plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.ops import nms as jnms
from demf_tpu_torch.ops import nms2d
from demf_tpu_torch.tools.nms_cases import nms2d_case


def jax_keep(boxes, scores, idxs, thresh, valid, grouped=True):
    fn = (jax.vmap(lambda bx, s, i, v: jnms.batched_nms_2d(bx, s, i, thresh,
                                                             v))
          if grouped else
          jax.vmap(lambda bx, s, i, v: jnms.nms_2d(bx, s, thresh, v)))
    return np.asarray(jax.jit(fn)(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(idxs), jnp.asarray(valid)))


CASES = [
    # b, n, groups, thresh, options
    (2, 300, 1, 0.5, {}),
    (2, 300, 5, 0.7, dict(ties=True)),
    (3, 400, 10, 0.5, dict(degenerate=True)),
    (2, 256, 10, 0.3, dict(ties=True, degenerate=True, invalid=0.6)),
    (1, 4200, 5, 0.7, {}),                         # the row-wise branch
    (1, 4200, 10, 0.5, dict(ties=True, invalid=0.8)),
    # the path's two calls: the RPN's level groups, the R-CNN's classes
    (1, 4390, 5, 0.7, dict(layout='rpn')),
    (1, 10000, 10, 0.5, dict(layout='rcnn')),
]


@pytest.mark.parametrize('b,n,groups,thresh,options', CASES)
def test_plain_batched_nms_2d_equals_jax(b, n, groups, thresh, options):
    boxes, scores, idxs, valid = nms2d_case(b, n, groups, seed=n + groups,
                                            **options)
    want = jax_keep(boxes, scores, idxs, thresh, valid)
    got = nms2d.batched_nms_2d(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(idxs), thresh,
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()        # some kept, some suppressed


@pytest.mark.parametrize('n', [200, 4200])
def test_plain_nms_2d_equals_jax(n):
    boxes, scores, idxs, valid = nms2d_case(2, n, 1, seed=n)
    want = jax_keep(boxes, scores, idxs, 0.6, valid, grouped=False)
    got = nms2d.nms_2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                       0.6, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('b,n,groups,thresh,options', [
    c for c in CASES if c[1] <= 400] + [(1, 1000, 5, 0.7, dict(ties=True))])
def test_k10_rule_equals_plain(b, n, groups, thresh, options):
    boxes, scores, idxs, valid = (torch.from_numpy(a) for a in nms2d_case(
        b, n, groups, seed=3 * n + groups, **options))
    want = nms2d.batched_nms_2d_plain(boxes, scores, idxs, thresh, valid)
    got = nms2d.batched_nms_2d_tiled(boxes, scores, idxs, thresh, valid)
    assert torch.equal(got, want)


def test_non_finite_boxes_and_scores():
    """A box with a NaN or infinite corner neither suppresses nor is
    suppressed; a NaN score comes last: the plain version, K10's rule and
    the JAX package agree."""
    boxes, scores, idxs, valid = nms2d_case(2, 120, 3, seed=5)
    boxes[0, 3, 0] = np.nan
    boxes[0, 9, 2] = np.inf
    boxes[1, 4] = boxes[1, 5]
    boxes[1, 4, 1] = -np.inf
    scores[1, 7] = np.nan
    valid[1, 7] = True
    want = jax_keep(boxes, scores, idxs, 0.5, valid)
    t = [torch.from_numpy(a) for a in (boxes, scores, idxs)]
    got = nms2d.batched_nms_2d_plain(*t, 0.5, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    tiled = nms2d.batched_nms_2d_tiled(*t, 0.5, torch.from_numpy(valid))
    assert torch.equal(tiled, got)


def test_k10_order_is_by_group_then_global_order():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.1, 0.9, 0.3]])
    idxs = torch.tensor([[1, 0, 1, 0, 1, 2]])
    valid = torch.tensor([[True, True, True, True, True, False]])
    order, groups = nms2d.k10_order(scores, idxs, valid)
    assert order.tolist() == [[1, 3, 4, 0, 2, 5]]
    assert groups[0, :5].tolist() == [0, 0, 1, 1, 1]
    assert groups[0, 5] == nms2d.INVALID_GROUP


def test_wrapper_refusals():
    boxes = torch.zeros(1, 4, 4)
    scores = torch.zeros(1, 4)
    with pytest.raises(ValueError, match='thresh'):
        nms2d.batched_nms_2d(boxes, scores, scores.long(), -0.1)
    with pytest.raises(ValueError, match='CUDA'):
        nms2d.batched_nms_2d_cuda(boxes, scores, scores.long(), 0.5,
                                  scores > 0)


@pytest.mark.parametrize('options', [dict(ties=True), dict(
    ties=True, degenerate=True, invalid=0.5), dict(layout='rpn')])
def test_k10_packed_order_equals_two_sorts(options):
    """K10's packed keys give the order of the two stable sorts: tied
    scores, -0.0 beside 0.0, NaN and -inf scores (valid and invalid),
    invalid entries last."""
    n = 4390 if options.get('layout') == 'rpn' else 300
    boxes, scores, idxs, valid = nms2d_case(2, n, 5, seed=n, **options)
    scores[:, 0:40:4] = 0.0
    scores[:, 1:40:4] = -0.0
    scores[:, 2:60:5] = np.nan
    scores[:, 3:60:6] = -np.inf
    scores[:, 60:70] = np.inf
    valid[:, 50:56] = True
    t = [torch.from_numpy(a) for a in (scores, idxs, valid)]
    want, groups = nms2d.k10_order(*t)
    got, keys = nms2d.k10_packed_order(*t)
    real = groups != nms2d.INVALID_GROUP
    # the valid entries in the same places; the invalid ones after them,
    # in an order that nothing reads
    assert torch.equal(got[real], want[real])
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)
    assert (keys >= 0).all() and (keys[:, 1:] > keys[:, :-1]).all()
    code = keys >> nms2d.GROUP_SHIFT
    assert torch.equal(code[real], groups[real])
    assert (code[~real] == nms2d.INVALID_CODE).all()


def test_k10_ids_sharing_their_low_bits_are_told_apart():
    """Ids that the key cannot tell apart (equal low 16 bits: 3 and
    3 + 2^16, negative ids) share a place in the order; K10's rule still
    keeps what the plain version keeps, as for any int64 id."""
    boxes, scores, idxs, valid = (torch.from_numpy(a) for a in nms2d_case(
        2, 400, 4, seed=11, ties=True))
    ids = torch.tensor([3, 3 + (1 << 16), -(1 << 16) + 3, -7])[idxs]
    want = nms2d.batched_nms_2d_plain(boxes, scores, ids, 0.5, valid)
    assert torch.equal(
        want, nms2d.batched_nms_2d_plain(boxes, scores, idxs, 0.5, valid))
    codes = nms2d.k10_packed_order(scores, ids, valid)[1] >> \
        nms2d.GROUP_SHIFT
    assert len(codes[0].unique()) == 3          # two ids share a code
    assert torch.equal(
        nms2d.batched_nms_2d_tiled(boxes, scores, ids, 0.5, valid), want)
