"""The port's rotated 3D IoU (``demf_tpu_torch/core/rotated_iou.py``) and
the class-wise rotated NMS (``ops/nms_rotated.py``, K15's plain version)
against the JAX package's (``demf_tpu/core/rotated_iou.py``,
``ops/nms.py::_greedy_suppress`` once a class as ``models/fcaf3d.py::
get_bboxes`` runs it), on the CPU, on boxes made with numpy from a seed:
spread boxes, boxes piled on a few centres, coincident copies, boxes far
apart and boxes of one yaw.  IoUs within 1e-5, keep masks equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.core import rotated_iou as J
from demf_tpu.ops.nms import _greedy_suppress
from demf_tpu_torch.core import rotated_iou as P
from demf_tpu_torch.ops import nms_rotated

CASES = ('spread', 'piled', 'coincident', 'apart', 'aligned')


def boxes_case(kind, n=48, seed=0):
    """(n, 7) depth boxes (x, y, z_bottom, dx, dy, dz, yaw)."""
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, 3:6] = rng.uniform(0.3, 1.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if kind == 'spread':
        b[:, :3] = rng.uniform(-2, 2, (n, 3))
    elif kind == 'piled':
        centres = rng.uniform(-2, 2, (4, 3))
        b[:, :3] = centres[rng.randint(0, 4, n)] + \
            rng.normal(0, 0.1, (n, 3))
    elif kind == 'coincident':
        b[:, :3] = rng.uniform(-2, 2, (n, 3))
        b[n // 2:] = b[:n - n // 2]
    elif kind == 'apart':
        b[:, 0] = np.arange(n) * 4.0
    else:
        b[:, :3] = rng.uniform(-1, 1, (n, 3))
        b[:, 6] = 0.25
    return b


@pytest.mark.parametrize('kind', CASES)
def test_iou3d_matrix_equals_jax(kind):
    b = boxes_case(kind)
    want = np.asarray(J.iou3d_matrix(jnp.asarray(b), jnp.asarray(b)))
    got = P.iou3d_matrix(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    # a box with itself: 1 to the roundings of corners up to 190 m out
    assert np.all(np.abs(np.diag(got) - 1) <= 1e-4)
    if kind == 'apart':
        assert not (got - np.diag(np.diag(got))).any()
    if kind == 'coincident':
        n = len(b) // 2
        assert np.all(np.abs(np.diag(got[n:, :n]) - 1) <= 1e-5)


def test_batched_matrix_and_aligned_equal_jax():
    b = np.stack([boxes_case('spread', seed=1), boxes_case('piled', seed=2)])
    got = P.iou3d_matrix(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    for i in range(2):
        want = np.asarray(J.iou3d_matrix(jnp.asarray(b[i]),
                                         jnp.asarray(b[i])))
        assert np.abs(got[i] - want).max() <= 1e-5
    a = boxes_case('piled', seed=3)
    c = boxes_case('piled', seed=3)
    c[:, :2] += 0.2
    want = np.asarray(J.iou3d_aligned(jnp.asarray(a), jnp.asarray(c)))
    got = P.iou3d_aligned(torch.from_numpy(a), torch.from_numpy(c)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    corners = P.bev_corners(torch.from_numpy(a)).numpy()
    want = np.stack([np.asarray(J.bev_corners(jnp.asarray(x))) for x in a])
    assert np.abs(corners - want).max() <= 1e-5


@pytest.mark.parametrize('kind', CASES)
def test_rotated_nms_3d_equals_jax(kind):
    b = boxes_case(kind, seed=4)
    rng = np.random.RandomState(5)
    scores = rng.rand(len(b)).astype(np.float32)
    classes = rng.randint(0, 3, len(b))
    valid = rng.rand(len(b)) < 0.9
    want = np.asarray(J.rotated_nms_3d(
        jnp.asarray(b), jnp.asarray(scores), jnp.asarray(classes), 0.3,
        jnp.asarray(valid)))
    got = P.rotated_nms_3d(
        torch.from_numpy(b)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(classes)[None], 0.3,
        torch.from_numpy(valid)[None])[0].numpy()
    assert np.array_equal(got, want)
    assert not got[~valid].any()


@pytest.mark.parametrize('kind', CASES)
def test_classwise_nms_equals_jax(kind):
    """Every class's sweep over the one IoU matrix, as get_bboxes: a box
    takes part in class c when it is valid and its score of c is above
    score_thr; NaN scores take no part."""
    b = boxes_case(kind, seed=6)
    rng = np.random.RandomState(7)
    probs = rng.rand(len(b), 4).astype(np.float32)
    probs[rng.rand(*probs.shape) < 0.2] = 0.005     # below score_thr
    probs[3, 1] = np.nan
    valid = rng.rand(len(b)) < 0.9
    iou = J.iou3d_matrix(jnp.asarray(b), jnp.asarray(b))
    want = np.stack([np.asarray(_greedy_suppress(
        iou, jnp.asarray(probs[:, c]), 0.5,
        jnp.asarray(valid) & (jnp.asarray(probs[:, c]) > 0.01)))
        for c in range(4)])
    got = nms_rotated.rotated_nms_classwise(
        torch.from_numpy(b)[None], torch.from_numpy(probs)[None],
        torch.from_numpy(valid)[None], 0.5, 0.01)[0].numpy()
    assert np.array_equal(got, want)
    assert got.any() and not got[1, 3]


def test_sweep_shared_bytes_fits_nms_pre():
    """K15's sweep holds a scene's bits (rows at an odd stride) and a
    class's keys, order and kept mask in shared memory: nms_pre 256 (the
    SUN RGB-D configs) takes 11.0 KB."""
    assert nms_rotated.sweep_shared_bytes(256) == 4 * (256 * 9 + 512 + 8)
    assert nms_rotated.sweep_shared_bytes(1312) <= 232448 < \
        nms_rotated.sweep_shared_bytes(1313)
