"""K12's order in plain torch (``ops/roi_align.py``:
``pyramid_roi_align_backward_tiles_plain``, ``k12_lists``, ``k12_chunks``)
against the JAX package's gradient of ``pyramid_roi_align`` and the port's
autograd of its plain version, on the CPU.

The kernel on the card equals the tiles plain version bit for bit
(``tests/test_torch_kernels.py``); here that version is held within 1e-5
of the largest gradient of ``jax.vjp`` of ``demf_tpu/models/rpn_roi.py::
pyramid_roi_align`` and of ``pyramid_roi_align_backward_plain``, its tile
lists against a count by hand, and its cut of long lists against the
kernel's rule.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.models import rpn_roi as jrpn
from demf_tpu_torch.ops import roi_align

LEVELS = ((16, 24), (8, 12), (4, 6), (2, 3))     # a 64x96 image's
STRIDES = (4, 8, 16, 32)


def case(seed=0, b=2, r=40, c=8, levels=LEVELS, piled=0):
    """Levels' shapes, RoIs of every size (some across and beyond the
    borders, whose corners clamp) and their mmdet levels, the first
    ``piled`` of each image within a pixel of one box; d_out."""
    rng = np.random.RandomState(seed)
    img_h, img_w = levels[0][0] * 4, levels[0][1] * 4
    xy = rng.uniform(-20, [img_w + 20, img_h + 20], (b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(1000), (b, r, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, :piled] = (np.array([20, 16, 44, 40], np.float32) +
                       rng.uniform(-1, 1, (b, piled, 4)))
    rois = torch.from_numpy(rois)
    d_out = torch.from_numpy(rng.randn(b, r, 7, 7, c).astype(np.float32))
    return (d_out, [(b, h, w, c) for h, w in levels], rois,
            roi_align.roi_levels(rois, len(levels)))


def largest_err(got, want):
    want = [np.asarray(w) for w in want]
    return (max(np.abs(np.asarray(g) - w).max() for g, w in zip(got, want)),
            max(np.abs(w).max() for w in want))


@pytest.mark.parametrize('seed,piled,chunk,slots', [
    (0, 0, roi_align.K12_CHUNK, None), (1, 20, roi_align.K12_CHUNK, None),
    (2, 20, 40, None), (3, 30, 16, 6), (4, 30, 7, 0), (5, 40, 3, 2),
    (6, 0, 1, None)])
def test_tiles_plain_matches_the_plain_autograd(seed, piled, chunk, slots):
    """Within 1e-5 of the largest gradient, with lists whole, cut into
    chunks, and cut into fewer chunks than they ask for (``slots``)."""
    d_out, shapes, rois, lvl = case(seed, piled=piled)
    got = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, STRIDES, chunk=chunk, slots=slots)
    err, largest = largest_err(got, roi_align.pyramid_roi_align_backward_plain(
        d_out, shapes, rois, lvl, STRIDES))
    assert err <= 1e-5 * largest


@pytest.mark.parametrize('seed,piled,samples', [(5, 0, 2), (6, 25, 2),
                                                (7, 10, 3)])
def test_tiles_plain_matches_jax(seed, piled, samples):
    """Against ``jax.vjp`` of the JAX package's ``pyramid_roi_align``
    vmapped over the images, within 1e-5 of the largest gradient."""
    d_out, shapes, rois, lvl = case(seed, piled=piled)
    _, vjp = jax.vjp(jax.jit(lambda fs: jax.vmap(
        lambda f, r, l: jrpn.pyramid_roi_align(f, r, l, STRIDES, 7, samples))(
            fs, jnp.asarray(rois.numpy()), jnp.asarray(lvl.numpy()))),
        tuple(jnp.zeros(sh, jnp.float32) for sh in shapes))
    want = vjp(jnp.asarray(d_out.numpy()))[0]
    got = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, STRIDES, 7, samples, chunk=32)
    err, largest = largest_err([g.numpy() for g in got], want)
    assert err <= 1e-5 * largest


def test_tile_lists_count_each_reaching_bin():
    """``k12_lists``' list lengths against a count by hand: for each tile,
    each RoI of the image on its level, each bin whose corner rows
    [first sample's near, last sample's far] meet the tile's rows and
    whose corner columns meet its columns; the kernel's tile order."""
    d_out, shapes, rois, lvl = case(10, b=2, r=12, piled=4)
    lists = roi_align.k12_lists(shapes, rois, lvl, STRIDES)
    (y0, y1, _, _), (x0, x1, _, _) = (lists['table']['y'],
                                      lists['table']['x'])
    grid, per_image = roi_align.k12_tiles(shapes)
    want = []
    for image in range(2):
        for level, (down, across) in enumerate(grid):
            for ty in range(down):
                for tx in range(across):
                    n = 0
                    for roi in range(12):
                        if int(lvl[image, roi]) != level:
                            continue
                        rows = sum(int(y0[image, roi, 2 * o]) <= ty * 8 + 7
                                   and int(y1[image, roi, 2 * o + 1]) >=
                                   ty * 8 for o in range(7))
                        cols = sum(int(x0[image, roi, 2 * o]) <= tx * 8 + 7
                                   and int(x1[image, roi, 2 * o + 1]) >=
                                   tx * 8 for o in range(7))
                        n += rows * cols
                    want.append(n)
    assert len(want) == 2 * per_image
    assert lists['tile_n'].tolist() == want


@pytest.mark.parametrize('chunk,slots', [(4, 1000), (4, 10), (3, 1),
                                         (5, 0), (100, 3)])
def test_chunks_cut_each_list_within_the_slots(chunk, slots):
    """The kernel's plan: a list of n entries in ceil(n / chunk) chunks of
    balanced length, where the lists of more than one chunk would take
    more than ``slots`` partial tiles each gets fewer (at least one),
    never more partial tiles than ``slots``, and every entry in a
    chunk."""
    n = torch.tensor([0, 1, 4, 5, 9, 17, 40, 3, 123, 8])
    length, chunks = roi_align.k12_chunks(n, chunk, slots)
    want = torch.clamp_min((n + chunk - 1) // chunk, 1)
    assert (chunks <= want).all() and (chunks >= 1).all()
    assert (length * chunks >= n).all() and ((chunks - 1) * length < n)[
        n > 0].all()
    assert int(chunks[chunks > 1].sum()) <= slots
    if int(want[want > 1].sum()) <= slots:
        assert torch.equal(chunks, want)


def test_tiles_plain_untouched_pixels_are_positive_zero():
    """Pixels no corner reaches hold +0.0 (the sums start from zero, so
    no pixel holds -0.0)."""
    d_out, shapes, rois, lvl = case(11, b=1, r=3)
    got = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, STRIDES, chunk=4)
    reached = roi_align.pyramid_roi_align_backward_plain(
        torch.ones_like(d_out), shapes, rois, lvl, STRIDES)
    assert sum(int((r == 0).sum()) for r in reached) > 0
    for g, r in zip(got, reached):
        zero = g[r == 0]
        assert (zero == 0).all() and not torch.signbit(zero).any()
        assert not torch.signbit(g[g == 0]).any()


@pytest.mark.parametrize('levels', [((1, 1),), ((5, 3), (1, 1)),
                                    ((3, 7), (2, 4), (1, 2), (1, 1))])
@pytest.mark.parametrize('samples', [1, 2, 3])
def test_tiles_plain_on_levels_smaller_than_a_tile(levels, samples):
    """A 1 x 1 level and levels smaller than one tile, 1 to 3 samples a
    bin axis: within 1e-5 of the largest gradient of the plain
    autograd."""
    d_out, shapes, rois, lvl = case(12, b=2, r=10, levels=levels)
    strides = STRIDES[:len(levels)]
    got = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, strides, 7, samples, chunk=8)
    err, largest = largest_err(got, roi_align.pyramid_roi_align_backward_plain(
        d_out, shapes, rois, lvl, strides, 7, samples))
    assert err <= 1e-5 * largest
