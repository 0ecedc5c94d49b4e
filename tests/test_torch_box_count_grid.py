"""K9's culling rule on the CPU: the grid over each scene's xy extent and
the cells each box's bounding circle covers (``ops/box_count.py::
box_cells``), which ``csrc/box_count.cu`` implements.  The count that tests
only the covered cells (``box_point_count_grid``) must equal the plain
count of every pair (``box_point_count_plain``) and the JAX package's
``jnp.sum(points_in_boxes(...), 0)`` under ``vmap``, count for count, and
every pair that the plain test counts must lie in a covered cell: on points
exactly on cell edges and on box faces and corners, at yaw 0, pi/4 and pi,
a box larger than the room, a scene whose points all share one x, and NaN
and infinite points and boxes.  The JAX side rounds the rotation
otherwise in the last bit, which may flip a point that lies on a face: at
random yaws (the ``faces`` case) one point of 7,200 flips, so that case is
held to the plain count only; every other case, faces at yaw 0, pi/4 and
pi among them, to JAX's too.  Counts are integers and compared for
equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demf_tpu.core import boxes as jboxes
from demf_tpu_torch.ops import box_count
from demf_tpu_torch.tools.nms_cases import BOX_GRID_CASES, box_grid_case

GRID = box_count.GRID
# the one case held to the plain count only (see above)
NOT_JAX = ('faces',)


def case(name, seed=0):
    return [torch.from_numpy(a) for a in box_grid_case(name, seed)]


def _jax_count(points, boxes):
    return np.asarray(jax.vmap(lambda pt, bx: jnp.sum(
        jboxes.points_in_boxes(pt[:, :3], bx), 0))(
            jnp.asarray(points.numpy()), jnp.asarray(boxes.numpy())))


@pytest.mark.parametrize('name', BOX_GRID_CASES)
def test_culled_count_equals_the_plain_count_and_jax(name):
    points, boxes = case(name)
    got = box_count.box_point_count_grid(points, boxes)
    want = box_count.box_point_count_plain(points, boxes)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got.sum()) > 0
    if name not in NOT_JAX:
        np.testing.assert_array_equal(got.numpy(), _jax_count(points, boxes))


@pytest.mark.parametrize('name', BOX_GRID_CASES)
def test_every_counted_pair_lies_in_a_covered_cell(name):
    """The cover is a superset of what the test counts: a pair that the
    plain test counts has its point in a cell of the box's cover (or among
    the non-finite points, which every box tests)."""
    points, boxes = case(name, seed=1)
    terms = box_count.box_terms(boxes)
    for i in range(points.shape[0]):
        cell, cover = box_count.box_cells(points[i], boxes[i])
        assert cell.shape == (points.shape[1],)
        assert ((cell >= 0) & (cell <= GRID * GRID)).all()
        assert ((cover >= 0) & (cover < GRID)).all()
        assert (cover[:, 0] <= cover[:, 1]).all()
        assert (cover[:, 2] <= cover[:, 3]).all()
        t = terms[i][None]
        shift = points[i, :, None, :3] - t[..., :3]
        lx = shift[..., 0] * t[..., 3] - shift[..., 1] * t[..., 4]
        ly = shift[..., 0] * t[..., 4] + shift[..., 1] * t[..., 3]
        inside = ((lx.abs() <= t[..., 5]) & (ly.abs() <= t[..., 6]) &
                  (shift[..., 2].abs() <= t[..., 7]))          # (P, N)
        col, row = (cell % GRID)[:, None], (cell // GRID)[:, None]
        covered = ((col >= cover[:, 0]) & (col <= cover[:, 1]) &
                   (row >= cover[:, 2]) & (row <= cover[:, 3]) |
                   (cell == GRID * GRID)[:, None])
        assert not (inside & ~covered).any()


def test_the_grid_spans_the_finite_extent_and_culls():
    """On a room of spread points the grid's cells hold the points in
    order of their place, and a box of 1.5 m covers a few percent of the
    cells; the points off the map go to the last cell."""
    points, boxes = case('non-finite')
    cell, cover = box_count.box_cells(points[0], boxes[0])
    x, y = points[0, :, 0], points[0, :, 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    assert torch.equal(cell == GRID * GRID, ~finite)
    assert cell[finite][x[finite].argmin()] % GRID == 0
    assert cell[finite][x[finite].argmax()] % GRID == GRID - 1
    assert cell[finite][y[finite].argmax()] // GRID == GRID - 1
    area = ((cover[:, 1] - cover[:, 0] + 1) * (cover[:, 3] - cover[:, 2] + 1))
    assert torch.equal(area[2], torch.tensor(GRID * GRID))   # the NaN box
    assert area[torch.arange(24) != 2].float().median() < 0.1 * GRID * GRID


def test_degenerate_extents_put_every_point_in_one_column_or_cell():
    """All points on one x: one column of cells, every box's cover in it;
    no finite point: every point in the last cell."""
    points, boxes = case('one x')
    cell, cover = box_count.box_cells(points[0], boxes[0])
    assert (cell % GRID == 0).all() and (cover[:, :2] == 0).all()
    nowhere = torch.full((40, 3), float('nan'))
    cell, cover = box_count.box_cells(nowhere, boxes[0])
    assert (cell == GRID * GRID).all()
    assert torch.equal(box_count.box_point_count_grid(nowhere[None],
                                                      boxes[:1]),
                       torch.zeros(1, 24, dtype=torch.int32))
