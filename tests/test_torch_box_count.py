"""The count of points in rotated boxes (K9's function, ``ops/box_count.py``)
on the CPU: the port's plain version against the JAX package's
``jnp.sum(points_in_boxes(...), 0)`` under ``vmap``, count for count, on
points kept 1e-4 from every face (the two packages' roundings of the
rotation differ in the last bit, which may flip a point that lies on a
face), and against the port's own unchunked ``points_in_boxes`` on any
points, faces included.  Counts are integers and compared for equality.
The kernel itself runs on the card only (``tests/test_torch_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.core import boxes as jboxes
from demf_tpu_torch.core import boxes as box_ops
from demf_tpu_torch.ops import box_count
from demf_tpu_torch.tools.nms_cases import BOX_KINDS, box_count_case


def _case(kind, b, p, n, seed, margin=None):
    return [torch.from_numpy(a) for a in
            box_count_case(kind, b, p, n, seed=seed, margin=margin)]


def _unchunked(points, boxes):
    return box_ops.points_in_boxes(points[..., :3], boxes).sum(
        -2, dtype=torch.int32)


@pytest.mark.parametrize('kind', ['spread', 'clustered'])
@pytest.mark.parametrize('b,p,n', [(1, 300, 16), (2, 257, 33), (3, 400, 64)])
def test_plain_count_equals_jax_under_vmap(kind, b, p, n):
    points, boxes = _case(kind, b, p, n, seed=p + n, margin=1e-4)
    got = box_count.box_point_count(points, boxes)
    want = jax.vmap(lambda pt, bx: jnp.sum(
        jboxes.points_in_boxes(pt[:, :3], bx), 0))(
            jnp.asarray(points.numpy()), jnp.asarray(boxes.numpy()))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


@pytest.mark.parametrize('kind', BOX_KINDS)
@pytest.mark.parametrize('chunk', [1, 10, 64, 100, 1000, None])
def test_chunked_plain_count_equals_points_in_boxes(kind, chunk):
    """Chunks that divide P (1, 10, 100) and that do not (64), one chunk
    beyond P, and the default; (B, P, 4) points read as they come."""
    points, boxes = _case(kind, 2, 100, 13, seed=5)
    assert points.shape == (2, 100, 4)
    got = box_count.box_point_count_plain(points, boxes, chunk=chunk)
    assert torch.equal(got, _unchunked(points, boxes))


def test_nan_points_and_boxes_count_nothing():
    points, boxes = _case('clustered', 2, 200, 9, seed=3)
    points[0, ::7, 0] = float('nan')
    points[1, 3, 2] = float('nan')
    boxes[0, 2, 3] = float('nan')          # a size
    boxes[1, 4, 6] = float('nan')          # a yaw
    boxes[1, 5, 0] = float('inf')          # a center
    got = box_count.box_point_count(points, boxes)
    assert torch.equal(got, _unchunked(points, boxes))
    assert got[0, 2] == 0 and got[1, 4] == 0 and got[1, 5] == 0
    clean = points.clone()
    clean[0, ::7] = 1e6
    clean[1, 3] = 1e6
    boxes[0, 2, 3] = boxes[1, 4, 6] = boxes[1, 5, 0] = 0.0
    kept = box_count.box_point_count(clean, boxes)
    assert torch.equal(got[0, :2], kept[0, :2]) and int(got.sum()) > 0


@pytest.mark.parametrize('b,p,n', [(2, 0, 5), (2, 50, 0), (0, 10, 3),
                                   (1, 1, 1)])
def test_empty_clouds_and_no_boxes(b, p, n):
    points, boxes = _case('spread', b, p, n, seed=1)
    got = box_count.box_point_count(points, boxes)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    assert torch.equal(got, _unchunked(points, boxes))


def test_box_terms_are_the_plain_tests_limits():
    """The terms K9 reads: gravity center, cos and sin of the yaw, half the
    size plus eps, by the same expressions as ``points_in_boxes``."""
    _, boxes = _case('spread', 2, 1, 7, seed=2)
    terms = box_count.box_terms(boxes)
    assert terms.shape == (2, 7, 8) and terms.is_contiguous()
    assert torch.equal(terms[..., :3], box_ops.gravity_center(boxes))
    assert torch.equal(terms[..., 3], torch.cos(boxes[..., 6]))
    assert torch.equal(terms[..., 4], torch.sin(boxes[..., 6]))
    assert torch.equal(terms[..., 5:], boxes[..., 3:6] * 0.5 + 1e-6)


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version; any other goes to K9's
    wrapper, which takes CUDA tensors only (no fallback)."""
    points = torch.zeros(1, 8, 4, device='meta')
    boxes = torch.zeros(1, 3, 7, device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        box_count.box_point_count(points, boxes)
