"""The aligned 3D NMS on the CPU: the port's plain version against the JAX
package's ``aligned_3d_nms`` under ``vmap``, and kernel K8's rule written
out in Python (``aligned_3d_nms_bitmask``: order by counting, suppression
bits, a sweep over the order) against the plain version.  Keep masks are
compared for equality: there is no tolerance.  The kernel itself runs on
the card only (``tests/test_torch_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.ops.nms import aligned_3d_nms as jax_nms
from demf_tpu_torch.ops import nms
from demf_tpu_torch.tools.nms_cases import KINDS, nms_case

# (kind, batch, boxes): the hard cases of the kernel's acceptance test, at
# sizes the Python emulation gets through; N = 500 is the plain version's
# alone
CASES = [(kind, 2, 96) for kind in KINDS] + [('ties', 1, 37),
                                             ('clustered', 3, 64)]


def _tensors(case):
    return [torch.from_numpy(a) for a in case]


@pytest.mark.parametrize('kind,b,n', CASES + [('clustered', 2, 500)])
def test_plain_nms_equals_jax_under_vmap(kind, b, n):
    case = nms_case(kind, b, n, seed=n)
    got = nms.aligned_3d_nms(*_tensors(case)[:3], 0.25, _tensors(case)[3])
    boxes, scores, classes, valid = (jnp.asarray(a) for a in case)
    want = jax.vmap(lambda bx, s, c, v: jax_nms(bx, s, c, 0.25, v))(
        boxes, scores, classes, valid)
    assert got.dtype == torch.bool and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[~_tensors(case)[3]].any()      # invalid boxes never kept
    if kind in ('clustered', 'one_class') and n >= 96:
        assert int(got.sum()) < int(case[3].sum()) // 2


@pytest.mark.parametrize('thresh', [0.0, 0.25, 0.6])
@pytest.mark.parametrize('kind,b,n', CASES)
def test_kernel_rule_in_python_equals_plain(kind, b, n, thresh):
    boxes, scores, classes, valid = _tensors(nms_case(kind, b, n, seed=n + 1))
    want = nms.aligned_3d_nms_plain(boxes, scores, classes, thresh, valid)
    got = nms.aligned_3d_nms_bitmask(boxes, scores, classes, thresh, valid)
    assert torch.equal(got, want)


def test_nan_and_infinite_boxes_suppress_nothing_and_nan_scores_come_last():
    """What a NaN does (``ops/nms.py``): boxes 0-2 are one box three times
    over; with a NaN or infinite coordinate a copy neither suppresses nor
    is suppressed; a NaN score sorts last, so a twin with any score wins."""
    box = [0., 0., 0., 1., 1., 1.]
    boxes = torch.tensor([[box, box, box, box, box]])
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6, 0.5]])
    classes = torch.zeros(1, 5, dtype=torch.int64)
    valid = torch.ones(1, 5, dtype=torch.bool)
    for fn in (nms.aligned_3d_nms, nms.aligned_3d_nms_bitmask):
        assert fn(boxes, scores, classes, 0.25, valid).tolist() == \
            [[True, False, False, False, False]]
        bad = boxes.clone()
        bad[0, 0, 3] = float('nan')
        bad[0, 2, 0] = float('-inf')
        assert fn(bad, scores, classes, 0.25, valid).tolist() == \
            [[True, True, True, False, False]]
        nan_first = scores.clone()
        nan_first[0, 0] = float('nan')
        assert fn(boxes, nan_first, classes, 0.25, valid).tolist() == \
            [[False, True, False, False, False]]


def test_nms_refuses_a_negative_threshold_and_defaults_to_all_valid():
    boxes, scores, classes, _ = _tensors(nms_case('clustered', 1, 40))
    with pytest.raises(ValueError, match='thresh'):
        nms.aligned_3d_nms(boxes, scores, classes, -0.1)
    with pytest.raises(ValueError, match='thresh'):
        nms.aligned_3d_nms(boxes, scores, classes, float('nan'))
    everything = torch.ones_like(scores, dtype=torch.bool)
    assert torch.equal(
        nms.aligned_3d_nms(boxes, scores, classes, 0.25),
        nms.aligned_3d_nms_plain(boxes, scores, classes, 0.25, everything))


MOST = 1184


@pytest.mark.parametrize('n,want', [(512, 55872), (256, 19744), (32, 1572)])
def test_shared_memory_reckoning(n, want):
    """The wrapper's reckoning of K8's shared memory: N rows of N / 32
    words, 45 bytes a box and a word of the removed mask a group of 32;
    DeMF's 512 boxes and VoteNet's 256 fit, MOST is the most a block
    holds."""
    from demf_tpu_torch.ops._cuda import SMEM_PER_BLOCK
    assert nms.nms_shared_bytes(n) == want
    assert nms.nms_shared_bytes(MOST) <= SMEM_PER_BLOCK < \
        nms.nms_shared_bytes(MOST + 1)


def test_multiclass_nms_3d_goes_through_the_wrapper(monkeypatch):
    """``models.vote_head.multiclass_nms_3d`` calls ``aligned_3d_nms`` once
    for the whole batch."""
    from demf_tpu_torch.models import vote_head
    calls = []

    def spy(boxes, *args, **kwargs):
        calls.append(tuple(boxes.shape))
        return nms.aligned_3d_nms(boxes, *args, **kwargs)

    monkeypatch.setattr(vote_head, 'aligned_3d_nms', spy)
    rng = np.random.RandomState(0)
    b, n, c = 3, 24, 10
    bbox = torch.from_numpy(np.concatenate(
        [rng.uniform(-1, 1, (b, n, 3)), rng.uniform(0.5, 1, (b, n, 3)),
         rng.uniform(-1, 1, (b, n, 1))], -1).astype(np.float32))
    out = vote_head.multiclass_nms_3d(
        torch.rand(b, n), torch.rand(b, n, c).softmax(-1), bbox,
        torch.from_numpy(rng.uniform(-1.5, 1.5, (b, 4000, 3)).astype(
            np.float32)),
        dict(nms_thr=0.25, score_thr=0.05, per_class_proposal=True))
    assert calls == [(b, n, 6)]
    assert out['valid'].shape == (b, n * c)


def _nms_scene(kind, b, n, c, seed, per_class, empty_scene):
    """A tiny batch for ``multiclass_nms_3d``: gravity-center boxes made
    from a ``box_count_case`` (points 1e-4 from every face), scores and
    class probabilities from a seed; with ``empty_scene`` the last scene's
    points lie far from every box."""
    from demf_tpu_torch.tools.nms_cases import box_count_case
    points, bottom = box_count_case(kind, b, 600, n, seed=seed, margin=1e-4)
    if empty_scene:
        points[-1, :, :2] += 50.0
    bbox = bottom.copy()
    bbox[..., 2] += bbox[..., 5] / 2
    rng = np.random.RandomState(seed)
    obj = rng.rand(b, n).astype(np.float32)
    logits = rng.normal(0, 2, (b, n, c)).astype(np.float32)
    sem = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cfg = dict(nms_thr=0.25, score_thr=0.05, per_class_proposal=per_class)
    return (obj, sem.astype(np.float32), bbox, points), cfg


@pytest.mark.parametrize('empty_scene', [False, True])
@pytest.mark.parametrize('per_class', [True, False])
@pytest.mark.parametrize('kind', ['spread', 'clustered'])
def test_multiclass_nms_3d_equals_jax(kind, per_class, empty_scene):
    """The port's ``multiclass_nms_3d`` (the count for the whole batch,
    then the NMS) against the JAX package's, vmapped over the scenes:
    boxes, scores, labels and the valid mask."""
    from demf_tpu.models.vote_head import multiclass_nms_3d as jax_mc
    from demf_tpu_torch.models.vote_head import multiclass_nms_3d
    arrays, cfg = _nms_scene(kind, 3, 40, 5, seed=11, per_class=per_class,
                             empty_scene=empty_scene)
    got = multiclass_nms_3d(*(torch.from_numpy(a) for a in arrays), cfg)
    want = jax_mc(*(jnp.asarray(a) for a in arrays), cfg)
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(want['valid']))
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  np.asarray(want['labels_3d']))
    np.testing.assert_array_equal(got['boxes_3d'].numpy(),
                                  np.asarray(want['boxes_3d']))
    np.testing.assert_allclose(got['scores_3d'].numpy(),
                               np.asarray(want['scores_3d']), rtol=1e-6)
    valid = got['valid'].numpy()
    assert valid[:2].any()
    if empty_scene:
        assert not valid[-1].any()


@pytest.mark.parametrize('b', [1, 3])
def test_multiclass_nms_3d_counts_the_batch_in_one_call(monkeypatch, b):
    """``models.vote_head.multiclass_nms_3d`` calls ``box_point_count``
    once for the whole batch, on the (B, P, 4) clouds as they come (the
    kernel reads them through their strides), and keeps a box when more
    than 5 points lie in it."""
    from demf_tpu_torch.models import vote_head
    from demf_tpu_torch.ops import box_count
    calls = []

    def spy(points, boxes, *args):
        calls.append((tuple(points.shape), tuple(boxes.shape)))
        return box_count.box_point_count(points, boxes, *args)

    monkeypatch.setattr(vote_head, 'box_point_count', spy)
    arrays, cfg = _nms_scene('clustered', b, 24, 10, seed=b,
                             per_class=False, empty_scene=False)
    obj, sem, bbox, points = (torch.from_numpy(a) for a in arrays)
    out = vote_head.multiclass_nms_3d(obj, sem, bbox, points, cfg)
    assert calls == [((b, 600, 4), (b, 24, 7))]
    bottom = bbox.clone()
    bottom[..., 2] -= bottom[..., 5] / 2
    few = box_count.box_point_count(points, bottom) <= 5
    assert not out['valid'][few].any() and out['valid'].any()


def test_multiclass_nms_3d_on_the_card_counts_through_the_kernel(
        monkeypatch):
    """Tensors off the CPU (``meta`` ones here: no card) take K9's wrapper,
    once for the whole batch, and never the plain count."""
    from demf_tpu_torch.models import vote_head
    from demf_tpu_torch.ops import box_count
    calls = []

    def kernel(points, boxes, eps=1e-6):
        calls.append((tuple(points.shape), tuple(boxes.shape),
                       points.device.type))
        return torch.zeros(boxes.shape[:2], dtype=torch.int32,
                           device=boxes.device)

    def plain(*args, **kwargs):
        raise AssertionError('the plain count ran on a tensor off the CPU')

    monkeypatch.setattr(box_count, 'box_point_count_cuda', kernel)
    monkeypatch.setattr(box_count, 'box_point_count_plain', plain)
    monkeypatch.setattr(vote_head, 'aligned_3d_nms',
                        lambda minmax, scores, classes, thr, valid: valid)
    b, n, c = 2, 24, 10
    out = vote_head.multiclass_nms_3d(
        torch.rand(b, n, device='meta'), torch.rand(b, n, c, device='meta'),
        torch.rand(b, n, 7, device='meta'),
        torch.rand(b, 600, 4, device='meta'),
        dict(nms_thr=0.25, score_thr=0.05, per_class_proposal=True))
    assert calls == [((b, 600, 4), (b, n, 7), 'meta')]
    assert out['valid'].shape == (b, n * c)
