"""The training path's pieces in the port against the JAX package, on the
CPU: the MSDA backward (the plain version's autograd, which K4 is held
against on the card) against ``jax.vjp`` of the JAX op on both of its
routes, the losses, the vote-head targets, the vote loss and the two head
losses.  Inputs are made with numpy from a seed; fp32 on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.core import coders as jcoders
from demf_tpu.models import losses as jlosses
from demf_tpu.models import target_assign as jta
from demf_tpu.models.demf_head import DeMFVoteHead as JDeMFVoteHead
from demf_tpu.models.vote_head import CAVoteHead as JCAVoteHead
from demf_tpu.models.vote_module import VoteModule as JVoteModule
from demf_tpu.ops.msda import multi_scale_deformable_attention as jmsda
from demf_tpu.zoo import tiny_demf_model_cfg
from demf_tpu_torch.core import coders
from demf_tpu_torch.models import losses, target_assign
from demf_tpu_torch.models.demf_head import DeMFVoteHead
from demf_tpu_torch.models.vote_head import CAVoteHead
from demf_tpu_torch.models.vote_module import VoteModule
from demf_tpu_torch.ops import msda


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _locations_off_grid(rng, shape, spatial_shapes, margin=1e-3):
    """Sampling locations (..., L, P, 2) in about [-0.1, 1.1] whose pixel
    coordinates x = loc * W - 0.5 (y likewise) lie at least ``margin`` pixel
    from an integer: d_loc jumps where x crosses a grid line, so a location
    on one would compare two sides of a step."""
    locs = np.zeros(shape, np.float32)
    for lvl, (h, w) in enumerate(spatial_shapes):
        for axis, size in ((0, w), (1, h)):
            pix = rng.uniform(-0.1 * size - 0.5, 1.1 * size - 0.5,
                              shape[:-3] + shape[-2:-1])
            frac = pix - np.floor(pix)
            pix = np.floor(pix) + np.clip(frac, 0.01, 0.99)
            loc = ((pix + 0.5) / size).astype(np.float32)
            x32 = loc * np.float32(size) - np.float32(0.5)
            assert np.all(np.abs(x32 - np.round(x32)) >= margin)
            locs[..., lvl, :, axis] = loc
    return locs


# small-q takes _make_small_q_msda (q * L * P * 8 < sum_HW); the other
# takes _make_msda's f32 recompute backward (_bwd)
@pytest.mark.parametrize('route,shapes,q', [
    ('small_q', ((20, 24), (10, 12), (5, 6)), 6),
    ('quad', ((6, 8), (3, 4)), 10)])
def test_msda_backward_matches_jax_vjp(route, shapes, q):
    b, heads, hd, p = 2, 2, 8, 2
    nl = len(shapes)
    s = sum(h * w for h, w in shapes)
    assert (q * nl * p * 8 < s) == (route == 'small_q')
    rng = np.random.RandomState(q)
    value = rng.randn(b, s, heads, hd).astype(np.float32)
    locs = _locations_off_grid(rng, (b, q, heads, nl, p, 2), shapes)
    aw = rng.rand(b, q, heads, nl, p).astype(np.float32)
    aw /= aw.sum((-1, -2), keepdims=True)
    g = rng.randn(b, q, heads * hd).astype(np.float32)

    want_out, vjp = jax.vjp(
        lambda v, l, a: jmsda(v, shapes, l, a, gather_dtype=jnp.float32),
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(aw))
    want = vjp(jnp.asarray(g))

    tv, tl, ta = (_t(x).requires_grad_() for x in (value, locs, aw))
    out = msda.multi_scale_deformable_attention(tv, shapes, tl, ta)
    out.backward(_t(g))
    assert _rel(out, want_out) < 1e-5
    for name, got, ref in zip(('d_value', 'd_loc', 'd_aw'),
                              (tv.grad, tl.grad, ta.grad), want):
        assert _rel(got, ref) <= 1e-5, name


def test_cross_entropy_and_regression_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 30, 5).astype(np.float32)
    labels = rng.randint(0, 5, (2, 30))
    weight = rng.rand(2, 30).astype(np.float32)
    cw = [0.2, 0.8, 1.0, 0.5, 2.0]
    for kw in (dict(class_weight=cw, reduction='sum', loss_weight=5.0),
               dict(reduction='mean'), dict(reduction='none')):
        got = losses.CrossEntropyLoss(**kw)(_t(logits), _t(labels),
                                            weight=_t(weight))
        want = jlosses.CrossEntropyLoss(**kw)(
            jnp.asarray(logits), jnp.asarray(labels),
            weight=jnp.asarray(weight))
        assert _rel(got, want) < 1e-6, kw
    pred = rng.randn(2, 30, 3).astype(np.float32)
    target = (pred + rng.randn(2, 30, 3) * 0.3).astype(np.float32)
    w3 = weight[..., None]
    for cls, kw in ((losses.SmoothL1Loss, dict(beta=1 / 9, reduction='sum',
                                               loss_weight=10.0)),
                    (losses.SmoothL1Loss, dict(beta=0.0)),
                    (losses.L1Loss, dict(reduction='sum'))):
        jcls = getattr(jlosses, cls.__name__)
        got = cls(**kw)(_t(pred), _t(target), weight=_t(w3))
        want = jcls(**kw)(jnp.asarray(pred), jnp.asarray(target),
                          weight=jnp.asarray(w3))
        assert _rel(got, want) < 1e-6, (cls.__name__, kw)
    lo = rng.randn(2, 30, 3).astype(np.float32)
    box_p = np.concatenate([lo, lo + rng.rand(2, 30, 3) + 0.1], -1)
    box_t = box_p + rng.randn(2, 30, 6).astype(np.float32) * 0.2
    got = losses.AxisAlignedIoULoss(reduction='sum', loss_weight=4.0)(
        _t(box_p.astype(np.float32)), _t(box_t.astype(np.float32)),
        weight=_t(weight))
    want = jlosses.AxisAlignedIoULoss(reduction='sum', loss_weight=4.0)(
        jnp.asarray(box_p, jnp.float32), jnp.asarray(box_t, jnp.float32),
        weight=jnp.asarray(weight))
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize('mode', ['l2', 'l1', 'smooth_l1'])
def test_chamfer_distance_matches_jax(mode):
    rng = np.random.RandomState(1)
    src = rng.randn(2, 20, 3).astype(np.float32)
    dst = rng.randn(2, 12, 3).astype(np.float32)
    valid = rng.rand(2, 12) < 0.7
    got = losses.chamfer_distance(_t(src), _t(dst), mode=mode,
                                  dst_valid=_t(valid))
    want = jlosses.chamfer_distance(jnp.asarray(src), jnp.asarray(dst),
                                    mode=mode, dst_valid=jnp.asarray(valid))
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) < 1e-6
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kw = dict(mode=mode, reduction='sum', loss_src_weight=2.0,
              loss_dst_weight=10.0)
    got = losses.ChamferDistance(**kw)(_t(src), _t(dst))
    want = jlosses.ChamferDistance(**kw)(jnp.asarray(src), jnp.asarray(dst))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-6


def _gt(rng, b=2, g=10, empty_scene=True):
    """Boxes large enough that points, votes and proposals fall in them;
    scene 1 without any valid box when ``empty_scene``."""
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :3] = rng.uniform(-1.5, 1.5, (b, g, 3))
    boxes[..., 3:6] = rng.uniform(0.8, 2.0, (b, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    labels = rng.randint(0, 10, (b, g))
    valid = rng.rand(b, g) < 0.7
    if empty_scene:
        valid[1] = False
    return boxes, labels, valid


@pytest.mark.parametrize('mode,coder_name', [
    ('demf', 'DeMFClassAgnosticBBoxCoder'),
    ('ca', 'ClassAgnosticBBoxCoder')])
def test_vote_head_targets_match_jax(mode, coder_name):
    rng = np.random.RandomState(2)
    boxes, labels, valid = _gt(rng)
    points = rng.uniform(-2, 2, (2, 200, 4)).astype(np.float32)
    agg = rng.uniform(-2, 2, (2, 24, 3)).astype(np.float32)
    cfg = dict(pos_distance_thr=0.6, neg_distance_thr=1.0)
    got = target_assign.get_vote_head_targets(
        _t(points), _t(boxes), _t(labels), _t(valid), _t(agg),
        getattr(coders, coder_name)(num_dir_bins=12), cfg, 3, mode=mode)
    want = jta.get_vote_head_targets(
        jnp.asarray(points), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(agg),
        getattr(jcoders, coder_name)(num_dir_bins=12), cfg, 3, mode=mode)
    assert set(got) == set(want)
    assert 0 < float(want['objectness_targets'].sum()) < 24
    assert 0 < float(want['vote_target_masks'].sum()) < 200
    for k, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            assert _rel(got[k], w) < 1e-5, k
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_vote_targets_overwrite_rule():
    """First, second and last box of a point that lies in four."""
    boxes = np.zeros((1, 4, 7), np.float32)
    boxes[0, :, 3:6] = 2.0
    boxes[0, :, :3] = [[0, 0, -1], [0.1, 0, -1], [0, 0.1, -1], [0.1, 0.1, -1]]
    points = np.zeros((1, 1, 3), np.float32)
    got, mask = target_assign._vote_targets(
        _t(points), _t(boxes), torch.ones(1, 4, dtype=torch.bool), 3)
    np.testing.assert_allclose(got[0, 0].numpy(),
                               [0, 0, 0, 0.1, 0, 0, 0.1, 0.1, 0], atol=1e-7)
    assert mask.tolist() == [[1]]


def _slot_scene(dtype):
    """Two scenes of 12 overlapping rotated boxes (some invalid) and 600
    points: points in 0 to 6 valid boxes, a NaN point."""
    rng = np.random.RandomState(11)
    boxes = np.concatenate([
        rng.uniform(-0.8, 0.8, (2, 12, 2)),
        rng.uniform(-1.2, -0.8, (2, 12, 1)),
        rng.uniform(0.6, 2.4, (2, 12, 2)), rng.uniform(2.0, 3.0, (2, 12, 1)),
        rng.uniform(-np.pi, np.pi, (2, 12, 1))], -1).astype(dtype)
    valid = rng.rand(2, 12) < 0.8
    points = rng.uniform(-2, 2, (2, 600, 3)).astype(dtype)
    points[1, 5] = np.nan
    return points, boxes, valid


@jax.jit
def jax_slot_targets(points, boxes, valid):
    """The JAX package's in-box mask (valid GT only) and its vote targets
    at gt_per_seed 1 to 4 (one compile a dtype)."""
    from demf_tpu.core import boxes as jboxes
    in_box = jax.vmap(jboxes.points_in_boxes)(points, boxes) & \
        valid[:, None]
    return in_box, [jax.vmap(lambda p, b, v, k=k: jta._vote_targets_single(
        p, b, v, k))(points, boxes, valid) for k in (1, 2, 3, 4)]


@pytest.fixture
def one_thread():
    """The test on one intra-op thread: small ops under the other test
    workers' threads slow by tens of times with torch's default pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _targets_by_walk(points, boxes, in_box, gt_per_seed):
    """K18's walk, point by point in numpy: the boxes that hold a point in
    order, slot 0 the first, slot min(n, S - 1) the n-th after it (the last
    slot overwritten), each slot's center - the point in the points' dtype,
    the first vote (box 0's when there is no hit) where a slot has none,
    times has1; and has1."""
    b, p, _ = in_box.shape
    s = gt_per_seed
    half = np.asarray(0.5, points.dtype)
    centers = np.concatenate([boxes[..., :2], boxes[..., 2:3] +
                              boxes[..., 5:6] * half], -1)
    targets = np.zeros((b, p, 3 * s), points.dtype)
    masks = np.zeros((b, p), np.int32)
    for i in range(b):
        for j in range(p):
            slot, n = [0] * s, 0
            for box in np.flatnonzero(in_box[i, j]):
                if n == 0 or s > 1:
                    slot[min(n, s - 1)] = box
                n += 1
            has1 = np.asarray(n > 0, points.dtype)
            first = centers[i, slot[0]] - points[i, j, :3]
            for k in range(s):
                v = centers[i, slot[k]] - points[i, j, :3] if 0 < k < n \
                    else first
                targets[i, j, 3 * k:3 * k + 3] = v * has1
            masks[i, j] = n > 0
    return targets, masks


def same_bits(got, want):
    got = np.ascontiguousarray(np.asarray(got))
    want = np.ascontiguousarray(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {4: np.int32, 8: np.int64}[got.itemsize]
    np.testing.assert_array_equal(got.view(ints), want.view(ints))


def check_vote_targets(points, boxes, valid, gt_per_seed, want):
    """K18's plain version (``ops/vote_targets.py::vote_targets_plain``,
    also through ``_vote_targets``) and its walk rule in numpy against the
    JAX package's (in-box mask, (targets, masks)) ``want``, bit for bit."""
    from demf_tpu_torch.ops.vote_targets import vote_targets_plain
    in_box, (want_t, want_m) = np.asarray(want[0]), want[1]
    got_t, got_m = vote_targets_plain(points, _t(boxes), _t(valid),
                                      gt_per_seed)
    assert got_t.dtype == points.dtype and got_m.dtype == torch.int32
    same_bits(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    via, via_m = target_assign._vote_targets(points, _t(boxes), _t(valid),
                                             gt_per_seed)
    same_bits(via.numpy(), want_t)
    np.testing.assert_array_equal(via_m.numpy(), np.asarray(want_m))
    walk_t, walk_m = _targets_by_walk(points.numpy(), boxes, in_box,
                                      gt_per_seed)
    same_bits(walk_t, want_t)
    np.testing.assert_array_equal(walk_m, np.asarray(want_m))
    return in_box


@pytest.mark.parametrize('gt_per_seed', [1, 2, 3, 4])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_vote_slots_and_targets_equal_jax(dtype, gt_per_seed, one_thread):
    """K18's plain version (``ops/vote_targets.py::vote_targets_plain``,
    the JAX package's expressions, and ``_vote_targets`` on it) and K18's
    walk rule in numpy against the JAX package's ``_vote_targets_single``
    at tolerance 0 (bit for bit), on points in 0, 1, 2, 3, 5 and more
    valid boxes and beside invalid GT."""
    points, boxes, valid = _slot_scene(dtype)
    with jax.enable_x64(dtype == np.float64):
        in_box, targets = jax_slot_targets(
            jnp.asarray(points), jnp.asarray(boxes), jnp.asarray(valid))
    in_box = check_vote_targets(_t(points), boxes, valid, gt_per_seed,
                                (in_box, targets[gt_per_seed - 1]))
    assert {0, 1, 2, 3, 5} <= set(in_box.sum(-1).ravel().tolist())


def _edge_scene(case):
    """Scenes for K18's edge cases (float32): ``faces`` points exactly on
    and just beyond the faces of axis-aligned and quarter-turned boxes,
    invalid boxes between valid ones, a NaN point and a NaN box;
    ``one_box`` a single GT slot (valid in one scene, not in the other);
    ``strided`` the (B, P, 4) cloud read as a (B, P, 3) view.  Returns
    (points as a torch tensor, boxes, valid)."""
    rng = np.random.RandomState(5)
    if case == 'faces':
        boxes = np.zeros((2, 6, 7), np.float32)
        boxes[..., :3] = rng.uniform(-1, 1, (2, 6, 3))
        boxes[..., 3:6] = rng.choice([0.5, 1.0, 1.5, 2.0], (2, 6, 3))
        boxes[:, 3:, 6] = np.float32(np.pi / 2)
        valid = np.tile([True, False, True, True, False, True], (2, 1))
        centers = boxes[..., :3] + np.stack(
            [0 * boxes[..., 5], 0 * boxes[..., 5], boxes[..., 5] / 2], -1)
        signs = rng.choice([-1.0, 1.0], (2, 6, 40, 3)).astype(np.float32)
        axis = rng.randint(0, 3, (2, 6, 40))
        beyond = np.where(rng.rand(2, 6, 40) < 0.3, 2e-6, 0.0)
        off = rng.uniform(-0.5, 0.5, (2, 6, 40, 3)) * boxes[:, :, None, 3:6]
        face = np.take_along_axis(
            boxes[:, :, None, 3:6] / 2 + beyond[..., None], axis[..., None],
            -1)
        np.put_along_axis(off, axis[..., None],
                          np.take_along_axis(signs, axis[..., None], -1) *
                          face, -1)
        points = (centers[:, :, None] + off).reshape(2, 240, 3).astype(
            np.float32)
        points[0, 7] = np.nan
        boxes[1, 4, 0] = np.nan
        return _t(points), boxes, valid
    points, boxes, valid = _slot_scene(np.float32)
    if case == 'one_box':
        return _t(points), boxes[:, :1].copy(), np.array([[True], [False]])
    cloud = np.concatenate([points, rng.rand(2, 600, 1).astype(np.float32)],
                           -1)
    return torch.from_numpy(cloud)[..., :3], boxes, valid


@pytest.mark.parametrize('gt_per_seed', [1, 2, 3, 4])
@pytest.mark.parametrize('case', ['faces', 'one_box', 'strided'])
def test_vote_targets_edge_cases_equal_jax(case, gt_per_seed, one_thread):
    """K18's plain version and walk rule against the JAX package's
    ``_vote_targets_single``, bit for bit, on points on box faces (inside
    within eps, outside beyond it), invalid boxes between valid ones, NaN
    points and boxes, G = 1 and strided (B, P, 4) clouds."""
    points, boxes, valid = _edge_scene(case)
    assert points.is_contiguous() == (case != 'strided')
    with jax.enable_x64(False):
        want = jax_slot_targets(jnp.asarray(points.numpy()),
                                jnp.asarray(boxes), jnp.asarray(valid))
    in_box = check_vote_targets(points, boxes, valid, gt_per_seed,
                                (want[0], want[1][gt_per_seed - 1]))
    if case == 'faces':
        assert in_box.any() and not in_box.all(-1).any()
        assert np.isnan(np.asarray(want[1][gt_per_seed - 1][0])[0, 7]).all()


def _vote_inputs(rng):
    boxes, labels, valid = _gt(rng)
    points = rng.uniform(-2, 2, (2, 300, 4)).astype(np.float32)
    seed_idx = np.stack([rng.permutation(300)[:40] for _ in range(2)])
    seed_pts = np.take_along_axis(points[..., :3], seed_idx[..., None], 1)
    votes = (seed_pts + rng.randn(2, 40, 3) * 0.2).astype(np.float32)
    return boxes, labels, valid, points, seed_idx, seed_pts, votes


def test_vote_loss_matches_jax():
    rng = np.random.RandomState(3)
    boxes, labels, valid, points, seed_idx, seed_pts, votes = \
        _vote_inputs(rng)
    valid[1] = rng.rand(10) < 0.7
    cfg = tiny_demf_model_cfg()['pts_bbox_head']['vote_module_cfg']
    targets = jta.get_vote_head_targets(
        jnp.asarray(points), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(seed_pts),
        jcoders.DeMFClassAgnosticBBoxCoder(num_dir_bins=12),
        dict(pos_distance_thr=0.3, neg_distance_thr=0.6), 3, mode='demf')
    vt, masks = targets['vote_targets'], targets['vote_target_masks']
    want = JVoteModule(**cfg, parent=None).get_loss(
        jnp.asarray(seed_pts), jnp.asarray(votes), jnp.asarray(seed_idx),
        masks, vt)
    tv = _t(votes).requires_grad_()
    got = VoteModule(**cfg).get_loss(_t(seed_pts), tv, _t(seed_idx),
                                     _t(np.asarray(masks)),
                                     _t(np.asarray(vt)))
    assert float(want) > 0
    assert _rel(got, want) < 1e-6
    got.backward()
    want_g = jax.grad(lambda v: JVoteModule(**cfg, parent=None).get_loss(
        jnp.asarray(seed_pts), v, jnp.asarray(seed_idx), masks, vt))(
            jnp.asarray(votes))
    assert _rel(tv.grad, want_g) < 1e-6


def _head_cfgs(coder):
    cfg = dict(tiny_demf_model_cfg()['pts_bbox_head'])
    cfg['bbox_coder'] = dict(cfg['bbox_coder'], type=coder)
    cfg['train_cfg'] = dict(pos_distance_thr=0.6, neg_distance_thr=1.0,
                            sample_mod='seed')
    cfg.pop('type')
    return cfg


@pytest.mark.parametrize('head', ['ca', 'demf'])
def test_head_losses_and_grads_match_jax(head):
    """CAVoteHead.loss (mode 'ca') and DeMFVoteHead.loss (the stage mean)
    on the same random predictions: loss dicts within 1e-5 relative and
    the gradients of their sum with respect to every prediction (the
    aggregated points included) within 1e-4 of the largest."""
    rng = np.random.RandomState(4)
    boxes, labels, valid, points, seed_idx, seed_pts, votes = \
        _vote_inputs(rng)
    valid[1] = rng.rand(10) < 0.7
    agg = votes[:, :24].copy()
    n = agg.shape[1]

    def stage(rs):
        return dict(obj_scores=rs.randn(2, n, 2),
                    sem_scores=rs.randn(2, n, 10),
                    dir_class=rs.randn(2, n, 12),
                    dir_res_norm=rs.randn(2, n, 12) * 0.3,
                    center=agg + rs.randn(2, n, 3) * 0.2,
                    size=rs.uniform(0.5, 2, (2, n, 3)),
                    distance=rs.uniform(0.2, 1.0, (2, n, 6)))

    if head == 'ca':
        coder, preds = 'ClassAgnosticBBoxCoder', stage(rng)
        for k in ('center', 'size'):
            preds.pop(k)
    else:
        coder = 'DeMFClassAgnosticBBoxCoder'
        preds = [stage(rng), stage(rng)]
        for p in preds:
            p.pop('distance')
    preds = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                   preds)
    fixed = dict(seed_points=seed_pts, seed_indices=seed_idx,
                 vote_points=votes)
    cfg = _head_cfgs(coder)
    jcls, tcls = (JCAVoteHead, CAVoteHead) if head == 'ca' else \
        (JDeMFVoteHead, DeMFVoteHead)
    if head == 'ca':
        cfg.pop('decoder')
        cfg['pred_layer_cfg'] = dict(cfg['pred_layer_cfg'])
        cfg['pred_layer_cfg'].pop('conv_pred_layers')
    jhead = jcls(**cfg, parent=None)
    port = tcls(**cfg)

    def jresults(pr, a):
        r = dict({k: jnp.asarray(v) for k, v in fixed.items()},
                 aggregated_points=a)
        if head == 'ca':
            return dict(r, **pr, ref_points=a)
        return dict(r, decode_res_all=pr)

    def jtotal(pr, a):
        ls = jhead.loss(jresults(pr, a), jnp.asarray(points),
                        jnp.asarray(boxes), jnp.asarray(labels),
                        jnp.asarray(valid))
        return sum(ls.values()), ls

    (_, want), want_g = jax.value_and_grad(jtotal, (0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, preds), jnp.asarray(agg))

    tpreds = jax.tree_util.tree_map(lambda x: _t(x).requires_grad_(), preds)
    tagg = _t(agg).requires_grad_()
    results = dict({k: _t(v) for k, v in fixed.items()},
                   aggregated_points=tagg)
    if head == 'ca':
        results.update(tpreds, ref_points=tagg)
    else:
        results['decode_res_all'] = tpreds
    got = port.loss(results, _t(points), _t(boxes), _t(labels), _t(valid))
    assert set(got) == set(want)
    for k in want:
        assert float(want[k]) > 0, k
        assert _rel(got[k], want[k]) < 1e-5, k
    sum(got.values()).backward()
    flat_t = jax.tree_util.tree_leaves(tpreds)
    flat_j = jax.tree_util.tree_leaves(want_g[0])
    for t, j in zip(flat_t, flat_j):
        assert _rel(t.grad, j) < 1e-4
    # 'demf' targets carry no gradient to the aggregated points; 'ca'
    # distance targets do
    agg_grad = torch.zeros_like(tagg) if tagg.grad is None else tagg.grad
    assert _rel(agg_grad, want_g[1]) < 1e-4
