"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX.)  Without a card
every test here skips.
"""
import numpy as np
import pytest
import torch

from demf_tpu_torch.ops import (box_count, gather_rows, grouping, mform, msda,
                                msda_fold, nms, nms2d, roi_align, sampling)
from demf_tpu_torch.tools.nms_cases import BOX_GRID_CASES, box_grid_case


def unambiguous_centers(points, centers, radius, k):
    """Centers with no point within 1e-5 of r^2 and no tie within 1e-6 at
    the K-th distance (fp noise of the matmul distance may flip those)."""
    d2 = np.sum((centers[:, None] - points[None]) ** 2, -1)
    near_r = np.any(np.abs(d2 - radius * radius) < 1e-5, 1)
    inside = np.where(d2 < radius * radius, d2, np.inf)
    kth = np.sort(inside, 1)[:, k - 1:k]
    with np.errstate(invalid='ignore'):       # inf - inf where none inside
        near_k = np.sum(np.isfinite(kth) & (np.abs(inside - kth) < 1e-6),
                        1) > 1
    return ~(near_r | near_k)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels build with nvcc for '
                    'sm_90a)')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('b,n,k', [(2, 3000, 256), (1, 20000, 512),
                                   (3, 100, 100)])
def test_fps_kernel_equals_plain(dev, b, n, k):
    xyz = torch.from_numpy(np.random.RandomState(n).uniform(
        -3, 3, (b, n, 3)).astype(np.float32)).to(dev)
    before = sampling.FPS_KERNEL.launches
    got = sampling.furthest_point_sample_cuda(xyz, k)
    assert sampling.FPS_KERNEL.launches == before + 1
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, k))


@pytest.mark.cuda
@pytest.mark.parametrize('b', [1, 16])
@pytest.mark.parametrize('n,k', [(20000, 64), (999, 200), (33, 33),
                                 (20000, 3), (2049, 40)])
def test_fps_kernel_ragged_shares_and_few_picks(dev, b, n, k):
    """N that no cluster or block divides (a cluster's last block and a
    block's last threads own fewer points, or none), fewer picks than the
    cluster has blocks, one scene and sixteen."""
    xyz = torch.from_numpy(np.random.RandomState(n + k).uniform(
        -3, 3, (b, n, 3)).astype(np.float32)).to(dev)
    got = sampling.furthest_point_sample_cuda(xyz, k)
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, k))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [20000, 999])
def test_fps_kernel_ties_go_to_the_lowest_index(dev, n):
    """Points on a coarse grid, most of them many times over: every step's
    largest distance is shared, also across the blocks of a cluster."""
    xyz = torch.from_numpy(np.random.RandomState(n).randint(
        0, 3, (2, n, 3)).astype(np.float32)).to(dev)
    got = sampling.furthest_point_sample_cuda(xyz, 64)
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 64))


@pytest.mark.cuda
@pytest.mark.parametrize('cluster,threads', [(1, 512), (2, 512), (4, 256),
                                             (8, 128), (8, 256), (8, 512)])
def test_fps_kernel_equals_plain_at_any_launch_shape(dev, cluster, threads):
    """The picks do not depend on how the wrapper cuts a scene over blocks
    and threads."""
    n, k = 4999, 300
    xyz = torch.from_numpy(np.random.RandomState(cluster).uniform(
        -3, 3, (3, n, 3)).astype(np.float32)).to(dev)
    out = torch.empty((3, k), dtype=torch.int64, device=dev)
    sampling.FPS_KERNEL(xyz.data_ptr(), out.data_ptr(), 3, n, k, cluster,
                        threads)
    assert torch.equal(out, sampling.furthest_point_sample_plain(xyz, k))


@pytest.mark.cuda
@pytest.mark.parametrize('cluster,threads', [(16, 128), (0, 128), (8, 48),
                                             (8, 1024), (1, 128)])
def test_fps_kernel_refuses_launch_shapes(dev, cluster, threads):
    """A cluster beyond the portable 8 blocks, a block that is no whole
    number of warps or too large, and more than 16 points a thread."""
    xyz = torch.zeros((1, 4999, 3), device=dev)
    out = torch.empty((1, 8), dtype=torch.int64, device=dev)
    before = sampling.FPS_KERNEL.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        sampling.FPS_KERNEL(xyz.data_ptr(), out.data_ptr(), 1, 4999, 8,
                            cluster, threads)
    assert sampling.FPS_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('n,m,k,radius,extent', [
    (3000, 128, 16, 0.3, 1.0),
    (20000, 256, 64, 0.2, 3.0),
    # every point inside the radius: many times what a center's list in
    # shared memory holds, so the list is pruned again and again
    (6000, 8, 32, 5.0, 1.0)])
def test_ball_query_kernel_equals_plain(dev, n, m, k, radius, extent):
    rng = np.random.RandomState(m)
    pts = rng.uniform(-extent, extent, (2, n, 3)).astype(np.float32)
    centers = pts[:, :m].copy()
    tp, tc = torch.from_numpy(pts).to(dev), torch.from_numpy(centers).to(dev)
    got = grouping.ball_query_cuda(radius, k, tp, tc).cpu().numpy()
    want = grouping.ball_query_plain(radius, k, tp, tc).cpu().numpy()
    compared = 0
    for bi in range(2):
        ok = unambiguous_centers(pts[bi], centers[bi], radius, k)
        compared += ok.sum()
        for i in np.where(ok)[0]:
            assert set(got[bi, i]) == set(want[bi, i]), (bi, i)
    assert compared >= 0.9 * 2 * m


def _dense_scene(dev, seed, b, n, m, extent=1.0):
    """Points uniform over a cube, an eighth of them twice (equal
    distances); the first M are the centers."""
    pts = np.random.RandomState(seed).uniform(
        -extent, extent, (b, n, 3)).astype(np.float32)
    pts[:, n // 2:n // 2 + n // 8] = pts[:, :n // 8]
    pts = torch.from_numpy(pts).to(dev)
    return pts, pts[:, :m].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize('k', [1, 16, 64])
@pytest.mark.parametrize('b,n,m,radius', [
    (2, 5003, 77, 0.3),       # M no multiple of a block's centers, N of a tile
    (16, 1000, 130, 0.5),     # the blocks of many centers
    (2, 20000, 2048, 0.2),    # the first SA module at batch 2
    (1, 6000, 8, 5.0)])       # every point in the radius
def test_ball_query_kernel_equals_plain_pick_for_pick(dev, k, b, n, m,
                                                      radius):
    """On a dense cloud with duplicated points the kernel's picks equal,
    index for index, the plain version's on distances rounded as the
    kernel rounds them (``sqdist_unfused``)."""
    pts, centers = _dense_scene(dev, n + k, b, n, m)
    before = grouping.BALL_QUERY_KERNEL.launches
    got = grouping.ball_query_cuda(radius, k, pts, centers)
    assert grouping.BALL_QUERY_KERNEL.launches == before + 1
    want = grouping.ball_query_plain(radius, k, pts, centers,
                                     distances=grouping.sqdist_unfused)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('k,radius', [(100, 5.0), (200, 5.0), (300, 0.7)])
def test_ball_query_kernel_long_lists(dev, k, radius):
    """K above 96 takes lists of 256 keys or more, which the kernel cuts
    with its sorting network where K up to 96 ranks by counting: with
    every point in the radius (many cuts) and with about as many as K."""
    pts, centers = _dense_scene(dev, k, 2, 2000, 9)
    assert grouping.ball_query_launch_shape(2, 9, 2000, k)[2] >= 256
    got = grouping.ball_query_cuda(radius, k, pts, centers)
    want = grouping.ball_query_plain(radius, k, pts, centers,
                                     distances=grouping.sqdist_unfused)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ball_query_kernel_matches_its_streamed_emulation(dev):
    """The plain emulation of the streaming top-K, fed the kernel's
    distances, at the kernel's own tile and list sizes."""
    pts, centers = _dense_scene(dev, 4, 1, 1500, 10)
    _, _, cap, tile = grouping.ball_query_launch_shape(1, 10, 1500, 16)
    got = grouping.ball_query_cuda(0.9, 16, pts, centers)
    want = grouping.ball_query_streamed_plain(
        0.9, 16, pts.cpu(), centers.cpu(), tile, cap,
        distances=lambda a, b: grouping.sqdist_unfused(
            a.to(dev), b.to(dev)).cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize('warps,per_warp,cap,tile', [
    (1, 1, 64, 32), (16, 2, 128, 2048), (8, 8, 64, 512), (3, 4, 256, 96),
    (8, 4, 128, 1024), (4, 1, 64, 4096)])
def test_ball_query_kernel_equals_plain_at_any_launch_shape(dev, warps,
                                                            per_warp, cap,
                                                            tile):
    """The picks do not depend on how a scene's centers are cut over blocks
    and warps, nor on the list and tile sizes (a short list is pruned more
    often)."""
    n, m, k, radius = 3001, 150, 16, 0.45
    pts, centers = _dense_scene(dev, warps, 3, n, m)
    out = torch.empty((3, m, k), dtype=torch.int64, device=dev)
    grouping.BALL_QUERY_KERNEL(pts.data_ptr(), centers.data_ptr(),
                               out.data_ptr(), 3, n, m, k, radius * radius,
                               warps, per_warp, cap, tile)
    want = grouping.ball_query_plain(radius, k, pts, centers,
                                     distances=grouping.sqdist_unfused)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize('warps,per_warp,cap,tile', [
    (8, 4, 32, 512),        # a list shorter than K + 32
    (8, 4, 96, 512),        # no power of two
    (8, 4, 64, 500),        # a tile that is no whole number of warps
    (17, 2, 64, 512), (0, 2, 64, 512), (8, 3, 64, 512),
    (16, 8, 256, 1024)])    # 262 KB of lists: more than a block may hold
def test_ball_query_kernel_refuses_launch_shapes(dev, warps, per_warp, cap,
                                                 tile):
    pts = torch.zeros((1, 600, 3), device=dev)
    out = torch.empty((1, 600, 16), dtype=torch.int64, device=dev)
    before = grouping.BALL_QUERY_KERNEL.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        grouping.BALL_QUERY_KERNEL(pts.data_ptr(), pts.data_ptr(),
                                   out.data_ptr(), 1, 600, 600, 16, 0.04,
                                   warps, per_warp, cap, tile)
    assert grouping.BALL_QUERY_KERNEL.launches == before


@pytest.mark.cuda
def test_ball_query_wrapper_refuses_what_fits_no_block(dev):
    """K 30,000 would need a list of 32,768 keys a center: the wrapper
    raises, nothing is truncated and no launch is counted."""
    pts = torch.zeros((1, 40000, 3), device=dev)
    before = grouping.BALL_QUERY_KERNEL.launches
    with pytest.raises(ValueError, match='does not fit'):
        grouping.ball_query_cuda(0.2, 30000, pts, pts[:, :4].contiguous())
    assert grouping.BALL_QUERY_KERNEL.launches == before


@pytest.mark.cuda
def test_ball_query_kernel_takes_a_view_off_the_16_byte_grid(dev):
    """The kernel copies points 16 bytes at a time and refuses a pointer
    off that grid; the wrapper hands it a copy instead."""
    pts, _ = _dense_scene(dev, 6, 3, 1001, 1)
    view = pts[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    centers = view[:, :50].contiguous()
    out = torch.empty((2, 50, 8), dtype=torch.int64, device=dev)
    before = grouping.BALL_QUERY_KERNEL.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        grouping.BALL_QUERY_KERNEL(view.data_ptr(), centers.data_ptr(),
                                   out.data_ptr(), 2, 1001, 50, 8, 0.09,
                                   4, 1, 64, 512)
    assert grouping.BALL_QUERY_KERNEL.launches == before
    got = grouping.ball_query_cuda(0.3, 8, view, centers)
    assert torch.equal(got, grouping.ball_query_plain(
        0.3, 8, view, centers, distances=grouping.sqdist_unfused))


@pytest.mark.cuda
@pytest.mark.parametrize('shapes,heads,hd,q,p', [
    (((16, 24), (8, 12)), 4, 32, 50, 3),
    (((100, 168), (50, 84), (25, 42), (13, 21)), 8, 32, 256, 2),
    (((7, 5),), 2, 16, 40, 4)])
def test_msda_kernel_matches_plain(dev, shapes, heads, hd, q, p):
    s = sum(h * w for h, w in shapes)
    nl = len(shapes)
    g = torch.Generator(device=dev).manual_seed(q)
    value = torch.randn(2, s, heads, hd, device=dev, generator=g)
    locs = torch.rand(2, q, heads, nl, p, 2, device=dev, generator=g)
    locs = locs * 1.2 - 0.1
    aw = torch.rand(2, q, heads, nl, p, device=dev, generator=g)
    got = msda.msda_cuda(value, shapes, locs, aw)
    want = msda.msda_plain(value, shapes, locs, aw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


ENCODER_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))


@pytest.mark.cuda
@pytest.mark.parametrize('shapes,heads,hd,p', [
    (ENCODER_SHAPES, 8, 32, 4),
    (((32, 48), (16, 24), (8, 12)), 4, 16, 3),
    (((32, 48), (16, 24), (8, 12)), 2, 8, 2),
    (((33, 47), (17, 24)), 2, 64, 4)])
@pytest.mark.parametrize('where', ['own', 'scattered', 'whole map',
                                   'off the map'])
def test_msda_kernel_tiles_match_plain(dev, shapes, heads, hd, p, where):
    """One query a token, so the finer levels go through the kernel's
    spatial tiles: with the encoder's own locations (inside the tiles'
    windows), with those scattered by 4 pixels (some inside a window, some
    outside, some across its edge), with locations over the whole map
    (outside every window: the corners come from global memory) and with
    locations around and beyond the map's edges (corners that read
    zero)."""
    from demf_tpu_torch.tools import encoder_sampling_locations
    s = sum(h * w for h, w in shapes)
    assert msda.msda_tiling(shapes, hd)[1] > 0
    g = torch.Generator(device=dev).manual_seed(hd)
    value = torch.randn(2, s, heads, hd, device=dev, generator=g)
    if where in ('own', 'scattered'):
        locs = encoder_sampling_locations(
            shapes, 2, heads, p, dev, jitter=0.5 if where == 'own' else 4.0)
    else:
        locs = torch.rand(2, s, heads, len(shapes), p, 2, device=dev,
                          generator=g)
        locs = locs * 1.2 - 0.1 if where == 'whole map' else locs * 3 - 1
    aw = torch.rand(2, s, heads, len(shapes), p, device=dev, generator=g)
    before = msda.MSDA_KERNEL.launches
    got = msda.msda_cuda(value, shapes, locs, aw)
    assert msda.MSDA_KERNEL.launches == before + 1
    want = msda.msda_plain(value, shapes, locs, aw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_msda_function_pairs_tiled_forward_with_backward_kernel(dev):
    """Through ``MSDAFunction`` at one query a token: K3's tiles forward,
    K4 backward, against the plain version's autograd."""
    from demf_tpu_torch.tools import encoder_sampling_locations
    shapes = ((32, 48), (16, 24), (8, 12))
    s = sum(h * w for h, w in shapes)
    g = torch.Generator(device=dev).manual_seed(3)
    value = torch.randn(2, s, 4, 32, device=dev, generator=g)
    locs = encoder_sampling_locations(shapes, 2, 4, 4, dev)
    aw = torch.rand(2, s, 4, 3, 4, device=dev, generator=g)
    grad = torch.randn(2, s, 128, device=dev, generator=g)
    results = []
    for fn in (msda.multi_scale_deformable_attention, msda.msda_plain):
        ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
        launched = (msda.MSDA_KERNEL.launches,
                    msda.MSDA_BACKWARD_KERNEL.launches)
        out = fn(ins[0], shapes, ins[1], ins[2])
        out.backward(grad)
        launched = (msda.MSDA_KERNEL.launches - launched[0],
                    msda.MSDA_BACKWARD_KERNEL.launches - launched[1])
        assert launched == ((1, 1) if fn is not msda.msda_plain else (0, 0))
        results.append([out.detach()] + [t.grad for t in ins])
    for got, want in zip(*results):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_msda_kernel_refuses_head_dim(dev):
    value, locs, aw, _ = _msda_inputs(dev, ((3, 4),), 1, 5, 2, 12, 2, 0)
    with pytest.raises(ValueError, match='divisor of'):
        msda.msda_cuda(value, ((3, 4),), locs, aw)


@pytest.mark.cuda
def test_msda_kernel_refuses_a_tile_beyond_its_limits(dev):
    """The entry point is told the largest tile of the table and refuses
    one that would overrun the block's slots (256 queries, 4 a thread)."""
    shapes = ((32, 48), (16, 24))
    s = sum(h * w for h, w in shapes)
    value, locs, aw, _ = _msda_inputs(dev, shapes, 1, s, 2, 32, 2, 0)
    info, tile_info, tiles, direct_from, max_tile = msda._tables(
        shapes, 32, True, dev)
    assert tiles and 0 < max_tile <= 256
    out = torch.empty((1, s, 64), device=dev)
    before = msda.MSDA_KERNEL.launches
    for too_large in (257, 0):
        with pytest.raises(RuntimeError, match='CUDA error'):
            msda.MSDA_KERNEL(value.data_ptr(), info.data_ptr(),
                             tile_info.data_ptr(), locs.data_ptr(),
                             aw.data_ptr(), out.data_ptr(), 1, s, s, 2, 32,
                             2, 2, tiles, direct_from, too_large)
    assert msda.MSDA_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['value', 'locs'])
def test_msda_kernel_refuses_misaligned_tensors(dev, which):
    """Its 16-byte loads of value rows and 8-byte loads of locations need
    pointers aligned so; a contiguous view 4 bytes into a buffer is not."""
    shapes = ((3, 4),)
    value, locs, aw, _ = _msda_inputs(dev, shapes, 1, 5, 2, 16, 2, 0)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 8 == 4
        return view

    if which == 'value':
        value = shifted(value)
    else:
        locs = shifted(locs)
    with pytest.raises(RuntimeError, match='CUDA error'):
        msda.msda_cuda(value, shapes, locs, aw)


def _msda_inputs(dev, shapes, b, q, heads, hd, p, seed):
    s = sum(h * w for h, w in shapes)
    g = torch.Generator(device=dev).manual_seed(seed)
    value = torch.randn(b, s, heads, hd, device=dev, generator=g)
    locs = torch.rand(b, q, heads, len(shapes), p, 2, device=dev,
                      generator=g) * 1.2 - 0.1
    aw = torch.rand(b, q, heads, len(shapes), p, device=dev, generator=g)
    grad = torch.randn(b, q, heads * hd, device=dev, generator=g)
    return value, locs, aw, grad


@pytest.mark.cuda
@pytest.mark.parametrize('shapes,heads,hd,q,p', [
    (((16, 24), (8, 12)), 4, 8, 50, 3),
    (((7, 5),), 2, 16, 40, 4),
    (((100, 168), (50, 84), (25, 42), (13, 21)), 8, 32, 256, 2)])
def test_msda_backward_kernel_matches_plain(dev, shapes, heads, hd, q, p):
    """K4 through the autograd.Function against the plain version's
    autograd: d_value, d_loc and d_aw within 1e-5 of the largest |ref|.
    Both sides round x = loc * W - 0.5 alike, so no sample sits on the
    other side of a grid line, where d_loc jumps."""
    value, locs, aw, grad = _msda_inputs(dev, shapes, 2, q, heads, hd, p, q)
    grads = []
    for fn in (msda.multi_scale_deformable_attention, msda.msda_plain):
        ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
        before = msda.MSDA_BACKWARD_KERNEL.launches
        fn(ins[0], shapes, ins[1], ins[2]).backward(grad)
        launched = msda.MSDA_BACKWARD_KERNEL.launches - before
        assert launched == (1 if fn is not msda.msda_plain else 0)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('shapes,heads,hd,p', [
    (ENCODER_SHAPES, 8, 32, 4),
    (((32, 48), (16, 24), (8, 12)), 4, 16, 3),
    (((32, 48), (16, 24), (8, 12)), 2, 8, 2),
    (((33, 47), (17, 24)), 2, 32, 4),       # tiles at a level's ragged edge
    (((32, 48), (16, 24)), 2, 4, 1)])
@pytest.mark.parametrize('where', ['own', 'scattered', 'whole map',
                                   'off the map'])
def test_msda_backward_kernel_tiles_match_plain(dev, shapes, heads, hd, p,
                                                where):
    """One query a token, so the finer levels go through K4's spatial
    tiles (entries linked by window row, one reduction a list) and the rest
    through its query-major kernel: the encoder's own locations (inside the
    tiles' windows), those scattered by 4 pixels (some across a window's
    edge), locations over the whole map (outside every window: straight to
    global memory) and around and beyond the map's edges (corners that add
    nothing, but whose location gradient the plain version has too).
    Padded tokens are zero rows of value."""
    from demf_tpu_torch.tools import encoder_sampling_locations
    s = sum(h * w for h, w in shapes)
    tiles, direct_from = msda._tables(shapes, hd, True, dev)[2:4]
    assert tiles > 0 and 0 < direct_from <= s
    g = torch.Generator(device=dev).manual_seed(hd)
    value = torch.randn(2, s, heads, hd, device=dev, generator=g)
    value[1, s // 3: s // 2] = 0.0
    if where in ('own', 'scattered'):
        locs = encoder_sampling_locations(
            shapes, 2, heads, p, dev, jitter=0.5 if where == 'own' else 4.0)
    else:
        locs = torch.rand(2, s, heads, len(shapes), p, 2, device=dev,
                          generator=g)
        locs = locs * 1.2 - 0.1 if where == 'whole map' else locs * 3 - 1
    aw = torch.rand(2, s, heads, len(shapes), p, device=dev, generator=g)
    grad = torch.randn(2, s, heads * hd, device=dev, generator=g)
    before = msda.MSDA_BACKWARD_KERNEL.launches
    got = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    assert msda.MSDA_BACKWARD_KERNEL.launches == before + 1
    ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
    want = torch.autograd.grad(
        msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
    for g_, w in zip(got, want):
        assert torch.isfinite(g_).all()
        assert (g_ - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('q,p', [(1409, 4), (None, 5), (None, 16)])
def test_msda_backward_kernel_takes_the_query_major_route(dev, q, p):
    """Queries that are not the tokens with more corners a level than the
    lists route takes, and tokens with more points a level than a tile's
    entries hold, all go through the query-major kernel."""
    shapes = ((32, 48), (16, 24), (8, 12))
    s = sum(h * w for h, w in shapes)
    if q:
        assert not msda.msda_rows_route(shapes, q, 4, 3, p, 32, torch.float32)
    value, locs, aw, grad = _msda_inputs(dev, shapes, 2, q or s, 4, 32, p, p)
    got = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
    want = torch.autograd.grad(
        msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
    for g_, w in zip(got, want):
        assert (g_ - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('what', ['max_tile', 'points', 'direct_from',
                                  'value', 'grad_out', 'd_value', 'locs',
                                  'd_locs'])
def test_msda_backward_kernel_refuses_without_a_counted_launch(dev, what):
    """The entry point refuses a tile beyond a block's slots, more points
    than a tile's entries hold, a ``direct_from`` beyond the queries, and,
    with tiles, pointers off the 16-byte (value, grad_out, d_value) or
    8-byte (locs, d_locs) grid; a refused call counts no launch."""
    shapes = ((32, 48), (16, 24))
    s = sum(h * w for h, w in shapes)
    points = 5 if what == 'points' else 2
    value, locs, aw, grad = _msda_inputs(dev, shapes, 1, s, 2, 32, points, 0)
    info, tile_info, tiles, direct_from, max_tile = msda._tables(
        shapes, 32, True, dev)
    assert tiles and 0 < max_tile <= 256
    t = dict(value=value, locs=locs, grad_out=grad,
             d_value=torch.zeros_like(value), d_locs=torch.empty_like(locs))
    if what in t:
        buf = torch.empty(t[what].numel() + 1, device=dev)
        view = buf[1:].view(t[what].shape)
        view.copy_(t[what])
        assert view.is_contiguous() and view.data_ptr() % 8 == 4
        t[what] = view
    if what == 'max_tile':
        max_tile = 257
    if what == 'direct_from':
        direct_from = s + 1
    before = msda.MSDA_BACKWARD_KERNEL.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        msda.MSDA_BACKWARD_KERNEL(
            t['value'].data_ptr(), info.data_ptr(), tile_info.data_ptr(),
            t['locs'].data_ptr(), aw.data_ptr(), t['grad_out'].data_ptr(),
            t['d_value'].data_ptr(), t['d_locs'].data_ptr(),
            torch.empty_like(aw).data_ptr(), 1, s, s, 2, 32, 2, points,
            tiles, direct_from, max_tile, 0)
    assert msda.MSDA_BACKWARD_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [64, 128])
def test_msda_backward_wrapper_refuses_head_dim(dev, hd):
    """K3 takes a head_dim of 64; K4's query-major kernel sums over a
    (query, head)'s channels within a warp and does not."""
    value, locs, aw, grad = _msda_inputs(dev, ((8, 8),), 1, 64, 2, hd, 2, 0)
    before = msda.MSDA_BACKWARD_KERNEL.launches
    with pytest.raises(ValueError, match='divides 32'):
        msda.msda_backward_cuda(value, ((8, 8),), locs, aw, grad)
    assert msda.MSDA_BACKWARD_KERNEL.launches == before


@pytest.mark.cuda
def test_msda_backward_kernel_refuses_head_dim(dev):
    value, locs, aw, grad = _msda_inputs(dev, ((3, 4),), 1, 5, 2, 12, 2, 0)
    with pytest.raises(ValueError, match='divides 32'):
        msda.msda_backward_cuda(value, ((3, 4),), locs, aw, grad)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n', [1024, 999])
def test_gather_rows_kernel_equals_plain(dev, dtype, n):
    """K5 bit for bit, with N a multiple of the TPU's 16-row blocks and
    not."""
    g = torch.Generator(device=dev).manual_seed(n)
    plane = torch.randn(3, n, 128, device=dev, generator=g).to(dtype)
    idx = torch.randint(0, n, (3, 5000), device=dev, generator=g,
                        dtype=torch.int32)
    idx[:, :16] = torch.arange(n - 16, n, device=dev, dtype=torch.int32)
    before = gather_rows.GATHER_ROWS_KERNEL.launches
    got = gather_rows.gather_rows(plane, idx)
    assert gather_rows.GATHER_ROWS_KERNEL.launches == before + 1
    assert torch.equal(got, gather_rows.gather_rows_plain(plane, idx))


@pytest.mark.cuda
def test_gather_rows_kernel_refuses_int64_indices(dev):
    plane = torch.zeros(1, 8, 128, device=dev)
    with pytest.raises(TypeError, match='int32'):
        gather_rows.gather_rows(plane, torch.zeros(1, 4, dtype=torch.long,
                                                   device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['lp_q_slot', 'slot_major'])
@pytest.mark.parametrize('hd', [16, 32, 64])
@pytest.mark.parametrize('lp,q', [(16, 300), (1, 1001), (16, 64), (5, 77)])
def test_msda_fold_kernel_matches_plain(dev, dtype, layout, hd, lp, q):
    """K6 with weights (BH, LP, Q, 4) and, read through their strides,
    slot-major (BH, LP, 4, Q): bit-equal to the plain fold (both round
    each product and sum in lp-major, then slot, order), at head widths
    16 / 32 / 64, LP 16 (the unrolled case), 1 and 5, and Q that fills no
    whole block; these rows take the vector kernel."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randn(2, lp, q, 4 * hd, device=dev, generator=g).to(dtype)
    assert msda_fold.fold_takes_vector_loads(rows)
    before = msda_fold.MSDA_FOLD_KERNEL.launches
    if layout == 'slot_major':
        w = torch.rand(2, lp, 4, q, device=dev, generator=g)
        got = msda_fold.slot_major_fold(rows, w)
        w = w.transpose(2, 3)
    else:
        w = torch.rand(2, lp, q, 4, device=dev, generator=g)
        got = msda_fold.weighted_slot_fold_batched(rows, w, hd=hd)
        w = w.to(dtype)
    assert msda_fold.MSDA_FOLD_KERNEL.launches == before + 1
    assert torch.equal(got, msda_fold.slot_fold_plain(rows, w))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,hd,offset', [
    (torch.bfloat16, 32, 1), (torch.float32, 32, 2), (torch.bfloat16, 12, 0),
    (torch.float32, 6, 0)])
@pytest.mark.parametrize('layout', ['lp_q_slot', 'slot_major'])
def test_msda_fold_scalar_kernel_takes_other_rows(dev, dtype, hd, offset,
                                                  layout):
    """Rows off the 16-byte grid (a data pointer a few elements in, hd not
    a multiple of 8 in bf16 or 4 in f32) take the scalar kernel: bit-equal
    too; the vector kernel asked for them refuses."""
    lp, q = 16, 301
    g = torch.Generator(device=dev).manual_seed(8)
    n = 2 * lp * q * 4 * hd
    buf = torch.randn(n + 64, device=dev, generator=g).to(dtype)
    start = (-buf.data_ptr() % 64) // buf.element_size() + offset
    rows = buf[start:start + n].view(2, lp, q, 4 * hd)
    assert not msda_fold.fold_takes_vector_loads(rows)
    w = torch.rand(2, lp, 4, q, device=dev, generator=g)
    if layout == 'slot_major':
        got = msda_fold.slot_major_fold(rows, w)
    else:
        w = w.transpose(2, 3).contiguous()
        got = msda_fold.slot_fold(rows, w)
    assert torch.equal(got, msda_fold.slot_fold_plain(rows, w.transpose(2, 3)
                                                      if layout ==
                                                      'slot_major' else w))
    out = torch.empty(2, q, hd, device=dev)
    with pytest.raises(RuntimeError, match='CUDA error'):
        msda_fold.MSDA_FOLD_KERNEL(
            rows.data_ptr(), w.data_ptr(), out.data_ptr(), 2, lp, q, hd,
            *w.stride(), int(dtype == torch.bfloat16), 0, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_mform_kernel_matches_plain(dev, dtype):
    """K7 within 1e-5 of the largest output (in practice bit-equal), with
    repeated indices among a query's 16 slots."""
    g = torch.Generator(device=dev).manual_seed(8)
    plane = torch.randn(3, 700, 32, device=dev, generator=g).to(dtype)
    idx16 = torch.randint(0, 40, (3, 16, 300, 1), device=dev, generator=g,
                          dtype=torch.int32)
    w16 = torch.rand(3, 16, 300, 1, device=dev, generator=g).to(dtype)
    got = mform.mform_sample(plane, idx16, w16)
    want = mform.mform_sample_plain(plane, idx16, w16).float()
    assert got.dtype == dtype
    assert (got.float() - want).abs().max() <= 1e-5 * want.abs().max()


def _mform_inputs(dev, seed, bh, n, k, q, hd, dtype, wdtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    plane = torch.randn(bh, n, hd, device=dev, generator=g).to(dtype)
    # some indices below 0 and beyond N: both sides clamp them
    idx16 = torch.randint(-3, n + 3, (bh, k, q, 1), device=dev, generator=g,
                          dtype=torch.int32)
    w16 = torch.rand(bh, k, q, 1, device=dev, generator=g).to(wdtype)
    return plane, idx16, w16


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [16, 32, 64])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('wdtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('q', [301, 1024])
def test_mform_kernel_equals_plain_bit_for_bit(dev, hd, dtype, wdtype, q):
    """Every width the kernel takes, either dtype of plane and weights, Q a
    multiple of the query tile and not (at Q 301 the rows of indices and
    weights start off the 16-byte grid and are copied element by element),
    indices out of range clamped."""
    plane, idx16, w16 = _mform_inputs(dev, hd + q, 3, 700, 16, q, hd, dtype,
                                      wdtype)
    assert int(idx16.min()) < 0 and int(idx16.max()) >= 700
    before = mform.MFORM_KERNEL.launches
    got = mform.mform_sample(plane, idx16, w16)
    assert mform.MFORM_KERNEL.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, mform.mform_sample_plain(plane, idx16, w16))


@pytest.mark.cuda
@pytest.mark.parametrize('q_tile,threads', [(8, 32), (64, 512), (256, 128),
                                            (512, 64), (40, 96)])
@pytest.mark.parametrize('k', [16, 5])
def test_mform_kernel_equals_plain_at_any_launch_shape(dev, q_tile, threads,
                                                       k):
    """The output does not depend on the query tile or the block, with K a
    multiple of the kernel's unrolled group of slots and not."""
    plane, idx16, w16 = _mform_inputs(dev, q_tile, 2, 333, k, 777, 32,
                                      torch.bfloat16, torch.bfloat16)
    out = torch.empty((2, 777, 32), dtype=torch.bfloat16, device=dev)
    mform.MFORM_KERNEL(plane.data_ptr(), idx16.data_ptr(), w16.data_ptr(),
                       out.data_ptr(), 2, 333, k, 777, 32, 1, 1, q_tile,
                       threads)
    assert torch.equal(out, mform.mform_sample_plain(plane, idx16, w16))


@pytest.mark.cuda
def test_mform_kernel_refuses_widths_pointers_and_launch_shapes(dev):
    """A row that is no whole number of 16-byte pieces (the wrapper says
    so before any launch), a plane off the 16-byte grid, a tile that is no
    multiple of 8 and a block beyond 512 threads."""
    plane, idx16, w16 = _mform_inputs(dev, 1, 2, 50, 4, 24, 10,
                                      torch.float32, torch.float32)
    before = mform.MFORM_KERNEL.launches
    with pytest.raises(ValueError, match='16-byte pieces'):
        mform.mform_sample(plane, idx16, w16)
    out = torch.empty((2, 24, 16), device=dev)

    def launch(p, hd, q_tile, threads):
        mform.MFORM_KERNEL(p.data_ptr(), idx16.data_ptr(), w16.data_ptr(),
                           out.data_ptr(), 2, 50, 4, 24, hd, 0, 0, q_tile,
                           threads)

    buf = torch.zeros(2 * 50 * 16 + 1, device=dev)
    shifted = buf[1:].view(2, 50, 16)
    assert shifted.data_ptr() % 16 == 4
    for args in ((plane, 10, 64, 128), (shifted, 16, 64, 128),
                 (buf, 16, 60, 128), (buf, 16, 64, 1024),
                 (buf, 16, 64, 100)):
        with pytest.raises(RuntimeError, match='CUDA error'):
            launch(*args)
    with pytest.raises(RuntimeError, match='CUDA error'):
        mform.mform_sample(shifted, idx16, w16)
    assert mform.MFORM_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('hd,p', [(8, 16), (32, 16), (32, 17)])
def test_msda_kernel_tiles_with_many_points(dev, hd, p):
    """Many points a level leave the tiles' windows little room (they
    shrink; the corners outside come from global memory); past
    ``MSDA_MAX_TILE_POINTS`` the wrapper takes the query-major mapping."""
    from demf_tpu_torch.tools import encoder_sampling_locations
    shapes = ((32, 48), (16, 24))
    s = sum(h * w for h, w in shapes)
    g = torch.Generator(device=dev).manual_seed(p)
    value = torch.randn(1, s, 2, hd, device=dev, generator=g)
    locs = encoder_sampling_locations(shapes, 1, 2, p, dev)
    aw = torch.rand(1, s, 2, 2, p, device=dev, generator=g)
    got = msda.msda_cuda(value, shapes, locs, aw)
    want = msda.msda_plain(value, shapes, locs, aw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _nms_inputs(dev, kind, b, n, seed=0):
    from demf_tpu_torch.tools.nms_cases import nms_case
    return [torch.from_numpy(a).to(dev) for a in nms_case(kind, b, n, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize('b,n', [(2, 512), (16, 512), (3, 500), (1, 32)])
@pytest.mark.parametrize('kind', ['random', 'clustered', 'ties', 'invalid',
                                  'degenerate', 'one_class'])
def test_nms_kernel_keep_masks_equal_plain(dev, kind, b, n):
    """K8 against the plain version, masks equal bit for bit: few and many
    suppressions, equal scores, invalid boxes and a wholly invalid scene,
    flat / inverted / identical boxes with NaN and infinite coordinates and
    scores, one class, N no multiple of 32; one launch a batch."""
    boxes, scores, classes, valid = _nms_inputs(dev, kind, b, n, seed=n + b)
    before = nms.NMS3D_KERNEL.launches
    got = nms.aligned_3d_nms(boxes, scores, classes, 0.25, valid)
    assert nms.NMS3D_KERNEL.launches == before + 1
    want = nms.aligned_3d_nms_plain(boxes, scores, classes, 0.25, valid)
    assert got.dtype == torch.bool and torch.equal(got, want)
    if kind in ('clustered', 'one_class') and n >= 500:
        assert int(want.sum()) < int(valid.sum()) // 2


@pytest.mark.cuda
@pytest.mark.parametrize('thresh', [0.0, 0.1, 0.5, 0.9])
@pytest.mark.parametrize('n', [1, 31, 33, 256, 1024, 1184])
def test_nms_kernel_any_threshold_and_size(dev, n, thresh):
    """One box, N around a word's 32 bits, the VoteNet size, the largest
    power of two and the most a block's shared memory holds; no valid mask
    given."""
    boxes, scores, classes, _ = _nms_inputs(dev, 'ties', 2, n, seed=n)
    got = nms.aligned_3d_nms(boxes, scores, classes, thresh)
    want = nms.aligned_3d_nms_plain(boxes, scores, classes, thresh,
                                    torch.ones_like(scores, dtype=torch.bool))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms_takes_views_of_any_strides(dev):
    """VoteNet's ``get_bboxes`` hands the NMS a slice of its softmax scores
    (the last column of (B, N, 2)): the wrapper launches K8 on contiguous
    copies, equal to the plain version."""
    boxes, scores, classes, valid = _nms_inputs(dev, 'random', 16, 256, 4)
    wide = torch.stack([1 - scores, scores], -1)
    view = wide[..., -1]
    assert not view.is_contiguous()
    before = nms.NMS3D_KERNEL.launches
    got = nms.aligned_3d_nms(boxes, view, classes, 0.25, valid)
    assert nms.NMS3D_KERNEL.launches == before + 1
    assert torch.equal(got, nms.aligned_3d_nms_plain(boxes, scores, classes,
                                                     0.25, valid))


@pytest.mark.cuda
def test_nms_kernel_refuses_what_it_cannot_take(dev):
    """More boxes than a block's shared memory holds, a negative
    threshold, other dtypes: each raises before any launch; an empty batch
    launches nothing."""
    boxes, scores, classes, valid = _nms_inputs(dev, 'random', 1, 1185)
    before = nms.NMS3D_KERNEL.launches
    with pytest.raises(ValueError, match='shared memory'):
        nms.aligned_3d_nms(boxes, scores, classes, 0.25, valid)
    boxes, scores, classes, valid = _nms_inputs(dev, 'random', 2, 64)
    with pytest.raises(ValueError, match='thresh'):
        nms.aligned_3d_nms(boxes, scores, classes, -0.1, valid)
    with pytest.raises(TypeError, match='classes'):
        nms.aligned_3d_nms(boxes, scores, classes.int(), 0.25, valid)
    with pytest.raises(TypeError, match='boxes'):
        nms.aligned_3d_nms(boxes.double(), scores, classes, 0.25, valid)
    assert nms.aligned_3d_nms(boxes[:0], scores[:0], classes[:0], 0.25,
                              valid[:0]).shape == (0, 64)
    assert nms.NMS3D_KERNEL.launches == before


def _box_count_inputs(dev, kind, b, p, n, seed=0):
    from demf_tpu_torch.tools.nms_cases import box_count_case
    return [torch.from_numpy(a).to(dev)
            for a in box_count_case(kind, b, p, n, seed=seed)]


@pytest.mark.cuda
@pytest.mark.parametrize('b,p,n', [(1, 37, 5), (2, 20000, 512),
                                   (16, 20000, 512), (3, 999, 1184)])
@pytest.mark.parametrize('kind', ['spread', 'clustered', 'faces'])
def test_box_count_kernel_equals_plain(dev, kind, b, p, n):
    """K9 against the plain count, bit for bit, on (B, P, 4) clouds read
    through their strides: points spread over the room, clustered around
    the boxes, and put on faces, edges and corners at the test's own limit
    (half + eps before the rotation rounds them); one launch a batch."""
    points, boxes = _box_count_inputs(dev, kind, b, p, n, seed=p + n)
    before = box_count.BOX_COUNT_KERNEL.launches
    got = box_count.box_point_count(points, boxes)
    assert box_count.BOX_COUNT_KERNEL.launches == before + 1
    want = box_count.box_point_count_plain(points, boxes)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if kind != 'spread' or p * n > 10 ** 5:     # 37 spread points miss
        assert int(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('view', ['xyz', 'channels_first', 'every_other',
                                  'nan'])
def test_box_count_kernel_reads_points_through_strides(dev, view):
    """Contiguous (B, P, 3) points, a (B, 3, P) buffer seen as (B, P, 3),
    every other point, and NaN points and boxes, which count nothing."""
    points, boxes = _box_count_inputs(dev, 'clustered', 2, 3001, 70, seed=4)
    if view == 'xyz':
        points = points[..., :3].contiguous()
    elif view == 'channels_first':
        points = points[..., :3].transpose(1, 2).contiguous().transpose(1, 2)
    elif view == 'every_other':
        points = points[:, ::2]
    else:
        points[0, ::5, 1] = float('nan')
        boxes[1, :7, 6] = float('nan')
    got = box_count.box_point_count(points, boxes)
    assert torch.equal(got, box_count.box_point_count_plain(points, boxes))
    if view == 'nan':
        assert not got[1, :7].any()


@pytest.mark.cuda
def test_box_count_kernel_refuses_what_it_cannot_take(dev):
    """Other dtypes, shapes and devices raise before any launch; a cloud
    without points or a batch without boxes launches nothing."""
    points, boxes = _box_count_inputs(dev, 'spread', 2, 100, 9)
    before = box_count.BOX_COUNT_KERNEL.launches
    with pytest.raises(TypeError, match='points'):
        box_count.box_point_count(points.double(), boxes)
    with pytest.raises(TypeError, match='boxes'):
        box_count.box_point_count(points, boxes.half())
    with pytest.raises(ValueError, match='do not go with'):
        box_count.box_point_count(points[..., :2], boxes)
    with pytest.raises(ValueError, match='do not go with'):
        box_count.box_point_count(points, boxes[..., :6])
    with pytest.raises(ValueError, match='do not go with'):
        box_count.box_point_count(points[:1], boxes)
    with pytest.raises(ValueError, match='CUDA tensor'):
        box_count.box_point_count(points, boxes.cpu())
    with pytest.raises(ValueError, match='3 dims'):
        box_count.box_point_count(points[0], boxes)
    assert torch.equal(box_count.box_point_count(points[:, :0], boxes),
                       torch.zeros(2, 9, dtype=torch.int32, device=dev))
    assert box_count.box_point_count(points, boxes[:, :0]).shape == (2, 0)
    assert box_count.BOX_COUNT_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('name', BOX_GRID_CASES)
def test_box_count_kernel_equals_plain_on_the_grid_cases(dev, name):
    """The cases of K9's culling rule (``tools/nms_cases.py::
    box_grid_case``: points on cell edges and box faces, yaw 0, pi/4 and
    pi, boxes larger than the room, one x, NaN and infinite points and
    boxes): the kernel's counts equal the plain count and the plain culled
    count on the card (the CPU's cosine may differ in the last bit, which
    moves points on faces), in at most four launches a call (the yaw's
    cosine and sine, the bin and the count kernel)."""
    from demf_tpu_torch.tools import device_kernels
    points, boxes = (torch.from_numpy(a).to(dev)
                     for a in box_grid_case(name))
    got = box_count.box_point_count(points, boxes)
    assert torch.equal(got, box_count.box_point_count_plain(points, boxes))
    assert torch.equal(got, box_count.box_point_count_grid(points, boxes))
    found = device_kernels(lambda: box_count.box_point_count(points, boxes))
    assert sum(n for n, _ in found.values()) <= 4
    assert sorted(k for k in found if 'box_count' in k) == [
        'box_count_bin_kernel', 'box_count_kernel']


@pytest.mark.cuda
def test_box_count_kernel_reads_a_cloud_wider_than_its_grid(dev):
    """A scene far from the origin (x near 1,000 m, where a float32 step
    is 6e-5 m) and one spread over 200 m: the margins keep every point
    the rounded test counts in a covered cell."""
    points, boxes = _box_count_inputs(dev, 'faces', 2, 20000, 512, seed=9)
    points[0, :, 0] += 1000.0
    boxes[0, :, 0] += 1000.0
    points[1, :, :2] *= 33.0
    boxes[1, :, :2] *= 33.0
    got = box_count.box_point_count(points, boxes)
    assert torch.equal(got, box_count.box_point_count_plain(points, boxes))
    assert int(got.sum()) > 0


# -- K3 / K4 on a bfloat16 value ---------------------------------------------
# Bounds: against the plain version in bfloat16 (float32 sums of the same
# widened values, rounded once) an output may land one bfloat16 step apart
# where the two float32 sums straddle a rounding boundary: 2^-7 of the
# largest |output|.  Against the float32 kernel on the same inputs rounded
# to bfloat16, each output is that sum rounded once: 2^-8 of itself, plus
# 1e-5 of the largest for the order of the float32 sums.  d_loc and d_aw
# stay float32: 1e-5 of the largest, as in float32.

BF16_STEP = 2.0 ** -7
BF16_HALF_STEP = 2.0 ** -8
# (B, Q or None for one query a token, P, locations): the encoder at batch
# 2 and 4, the stage-2 decoder at batch 16, the pretrain decoder at batch 4
BF16_SHAPES = [(2, None, 4, 'own'), (4, None, 4, 'own'),
               (2, None, 4, 'scattered'), (16, 256, 2, 'whole map'),
               (4, 300, 4, 'whole map')]


def _bf16_inputs(dev, b, q, p, where, seed=0):
    from demf_tpu_torch.tools import encoder_sampling_locations
    shapes = ENCODER_SHAPES
    s = sum(h * w for h, w in shapes)
    q = q or s
    g = torch.Generator(device=dev).manual_seed(seed)
    value = torch.randn(b, s, 8, 32, device=dev, generator=g).bfloat16()
    if where == 'whole map':
        locs = torch.rand(b, q, 8, 4, p, 2, device=dev, generator=g)
        locs = locs * 1.2 - 0.1
    else:
        locs = encoder_sampling_locations(
            shapes, b, 8, p, dev, jitter=0.5 if where == 'own' else 4.0)
    aw = torch.rand(b, q, 8, 4 * p, device=dev, generator=g)
    aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p)
    grad = torch.randn(b, q, 256, device=dev, generator=g).bfloat16()
    return shapes, value, locs, aw, grad


def _within(got, want, rel_each, rel_max):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= rel_each * want.abs() +
                 rel_max * want.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize('b,q,p,where', BF16_SHAPES)
def test_msda_kernel_reads_a_bf16_value(dev, b, q, p, where):
    """K3's bf16 entry: output in bf16, within one bf16 step of the largest
    output of the plain version in bf16, and each output the rounding of
    the float32 kernel's on the same (rounded) inputs."""
    shapes, value, locs, aw, _ = _bf16_inputs(dev, b, q, p, where)
    before = (msda.MSDA_KERNEL.launches, msda.MSDA_BF16_KERNEL.launches)
    got = msda.msda_cuda(value, shapes, locs, aw)
    assert (msda.MSDA_KERNEL.launches,
            msda.MSDA_BF16_KERNEL.launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    want = msda.msda_plain(value, shapes, locs, aw)
    assert want.dtype == torch.bfloat16
    assert _within(got, want, 0.0, BF16_STEP)
    assert _within(got, msda.msda_cuda(value.float(), shapes, locs, aw),
                   BF16_HALF_STEP, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('b,q,p,where', BF16_SHAPES)
def test_msda_backward_kernel_reads_a_bf16_value(dev, b, q, p, where):
    """K4's bf16 entry: d_value in bf16 (float32 sums rounded once), d_loc
    and d_aw in float32, against the plain version's autograd in bf16 and
    against the float32 kernel on the same rounded inputs."""
    shapes, value, locs, aw, grad = _bf16_inputs(dev, b, q, p, where, 1)
    before = (msda.MSDA_BACKWARD_KERNEL.launches,
              msda.MSDA_BACKWARD_BF16_KERNEL.launches)
    got = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    assert (msda.MSDA_BACKWARD_KERNEL.launches,
            msda.MSDA_BACKWARD_BF16_KERNEL.launches) == (before[0],
                                                         before[1] + 1)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
    want = torch.autograd.grad(
        msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
    ref32 = msda.msda_backward_cuda(value.float(), shapes, locs, aw,
                                    grad.float())
    assert _within(got[0], want[0], 0.0, BF16_STEP)
    assert _within(got[0], ref32[0], BF16_HALF_STEP, 1e-5)
    for g_, w, r in zip(got[1:], want[1:], ref32[1:]):
        assert torch.isfinite(g_).all()
        assert _within(g_, w, 0.0, 1e-5) and _within(g_, r, 0.0, 1e-5)


# K4's row-owner route: a bf16 value whose queries are not the tokens (the
# decoders); (B, Q, P) of the stage-2 and the pretrain decoder
ROW_ROUTE_SHAPES = [(16, 256, 2), (4, 300, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize('b,q,p', ROW_ROUTE_SHAPES)
def test_msda_backward_bf16_row_route_is_its_plain_order_every_call(dev, b, q,
                                                                    p):
    """At both decoder shapes d_value is the same bits from call to call
    and equals ``msda_backward_rows_plain`` (the same float32 sums in the
    same order, rounded once), and so are d_loc and d_aw between calls."""
    shapes, value, locs, aw, grad = _bf16_inputs(dev, b, q, p, 'whole map', 2)
    assert msda.msda_rows_route(shapes, q, 8, 4, p, 32, torch.bfloat16)
    first = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    again = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    assert torch.equal(first[0], msda.msda_backward_rows_plain(
        value, shapes, locs, aw, grad))


@pytest.mark.cuda
@pytest.mark.parametrize('b,q,p', ROW_ROUTE_SHAPES)
def test_msda_backward_bf16_row_route_takes_no_float32_plane(dev, b, q, p):
    """The call takes no memory beyond its outputs and the entry lists (1
    MiB for the allocator's rounding): no float32 buffer the size of the
    value, where the plane route took 2 bytes more a value; and it runs
    three kernels (entries, sort, rows), no rounding pass."""
    from demf_tpu_torch.tools import call_bytes, device_kernels
    shapes, value, locs, aw, grad = _bf16_inputs(dev, b, q, p, 'whole map', 3)
    s = value.shape[1]
    msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    taken = call_bytes(
        lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad))
    allowed = (value.numel() * 2 + (locs.numel() + aw.numel()) * 4 +
               msda.msda_rows_scratch_bytes(b, s, q, 8, 4, p, torch.bfloat16) +
               2 ** 20)
    assert taken <= allowed < value.numel() * 4
    found = device_kernels(
        lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad))
    assert sorted(found) == ['msda_backward_entries_kernel',
                             'msda_backward_rows_kernel',
                             'msda_backward_sort_kernel']
    assert all(n == 1 for n, _ in found.values())


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['off the map', 'one place', 'edges',
                                   'whole map'])
@pytest.mark.parametrize('heads,hd,q,p', [(8, 32, 50, 4), (4, 16, 7, 3),
                                          (2, 8, 1, 1), (4, 32, 600, 2)])
def test_msda_backward_bf16_row_route_matches_plain(dev, where, heads, hd, q,
                                                    p):
    """Small decoders on the row-owner route: every corner off the map (no
    entry: d_value all zero), every sample at one place (a few rows with
    long lists), locations on and beyond the map's edges (corners of weight
    0 whose location gradient is not), and over the whole map; head_dims
    8 to 32.  d_value equals the plain row order bit for bit and lies
    within one bf16 step of the plain autograd's largest, d_loc and d_aw
    within 1e-5."""
    shapes = ((32, 48), (16, 24), (8, 12))
    s = sum(h * w for h, w in shapes)
    assert msda.msda_rows_route(shapes, q, heads, 3, p, hd, torch.bfloat16)
    value, locs, aw, grad = _msda_inputs(dev, shapes, 2, q, heads, hd, p,
                                         q + hd)
    if where == 'off the map':
        locs = locs - 1.5
    elif where == 'one place':
        locs[:] = torch.tensor([0.37, 0.58], device=dev)
    elif where == 'edges':
        locs = torch.round(locs * 4) / 4
    value, grad = value.bfloat16(), grad.bfloat16()
    before = msda.MSDA_BACKWARD_BF16_KERNEL.launches
    got = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    assert msda.MSDA_BACKWARD_BF16_KERNEL.launches == before + 1
    assert torch.equal(got[0], msda.msda_backward_rows_plain(
        value, shapes, locs, aw, grad))
    if where == 'off the map':
        assert not got[0].any()
    ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
    want = torch.autograd.grad(
        msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
    assert _within(got[0], want[0], 0.0, BF16_STEP)
    for g_, w in zip(got[1:], want[1:]):
        assert _within(g_, w, 0.0, 1e-5)
    assert s == value.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize('what', ['tiles', 'entries', 'head_dim',
                                  'grad_out'])
def test_msda_backward_bf16_row_route_refuses_without_a_counted_launch(dev,
                                                                       what):
    """The entry refuses the row-owner route with tiles, more than 22,528
    entries a (scene, head, level), a head_dim that is not a multiple of 8,
    or a grad_out off the 16-byte grid; a refused call counts no launch."""
    shapes = ((32, 48), (16, 24))
    s = sum(h * w for h, w in shapes)
    q = 5633 if what == 'entries' else 40
    hd = 4 if what == 'head_dim' else 32
    value, locs, aw, grad = _msda_inputs(dev, shapes, 1, q, 2, hd, 1, 0)
    value, grad = value.bfloat16(), grad.bfloat16()
    info, tile_info = msda._tables(shapes, hd, True, dev)[:2]
    if what == 'grad_out':
        buf = torch.empty(grad.numel() + 1, dtype=grad.dtype, device=dev)
        grad = buf[1:].view(grad.shape)
    scratch = torch.empty(
        msda.msda_rows_scratch_bytes(1, s, q, 2, 2, 1, torch.bfloat16),
        dtype=torch.uint8, device=dev)
    before = msda.MSDA_BACKWARD_BF16_KERNEL.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        msda.MSDA_BACKWARD_BF16_KERNEL(
            value.data_ptr(), info.data_ptr(), tile_info.data_ptr(),
            locs.data_ptr(), aw.data_ptr(), grad.data_ptr(),
            scratch.data_ptr(), torch.empty_like(value).data_ptr(),
            torch.empty_like(locs).data_ptr(),
            torch.empty_like(aw).data_ptr(), 1, s, q, 2, hd, 2, 1,
            1 if what == 'tiles' else 0, 0, 0, 32 * 48)
    assert msda.MSDA_BACKWARD_BF16_KERNEL.launches == before


# K4's lists route on a float32 value: (B, Q, P) of the stage-2 and the
# pretrain decoder and a small decoder, on the encoder's levels
F32_ROUTE_SHAPES = [(16, 256, 2), (4, 300, 4), (2, 40, 3)]


def _f32_route_inputs(dev, b, q, p, where, seed=0):
    from demf_tpu_torch.tools import decoder_sampling_locations
    shapes = ENCODER_SHAPES
    s = sum(h * w for h, w in shapes)
    g = torch.Generator(device=dev).manual_seed(seed)
    value = torch.randn(b, s, 8, 32, device=dev, generator=g)
    locs = decoder_sampling_locations(shapes, b, q, 8, p, dev, where, seed)
    aw = torch.rand(b, q, 8, 4 * p, device=dev, generator=g)
    aw = (aw / aw.sum(-1, keepdim=True)).reshape(b, q, 8, 4, p)
    grad = torch.randn(b, q, 256, device=dev, generator=g)
    return shapes, value, locs, aw, grad


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['whole map', 'crowded', 'piled'])
@pytest.mark.parametrize('b,q,p', F32_ROUTE_SHAPES)
def test_msda_backward_f32_route_is_its_plain_order_every_call(dev, b, q, p,
                                                               where):
    """A float32 decoder's d_value is the same bits from call to call and
    equals ``msda_backward_rows_plain`` (the same float32 sums in the same
    order), though its memory is handed over full of NaN (freed just
    before): every row is written, none is skipped; d_loc and d_aw lie
    within 1e-5 of the largest of the plain autograd's."""
    shapes, value, locs, aw, grad = _f32_route_inputs(dev, b, q, p, where, 4)
    s = value.shape[1]
    assert msda.msda_rows_route(shapes, q, 8, 4, p, 32, torch.float32)
    junk = torch.full((value.numel() + 2 ** 20,), float('nan'), device=dev)
    del junk
    before = msda.MSDA_BACKWARD_KERNEL.launches
    first = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    assert msda.MSDA_BACKWARD_KERNEL.launches == before + 1
    assert not torch.isnan(first[0]).any()
    again = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    del again
    assert torch.equal(first[0], msda.msda_backward_rows_plain(
        value, shapes, locs, aw, grad))
    ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
    want = torch.autograd.grad(
        msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
    for g_, w in zip(first, want):
        assert (g_ - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('b,q,p', F32_ROUTE_SHAPES)
def test_msda_backward_f32_route_takes_no_fill_and_no_atomics(dev, b, q, p):
    """The call runs one kernel, the lists kernel: no fill of d_value and
    not the query-major kernel with its float atomics; it takes no memory
    beyond its outputs (1 MiB for the allocator's rounding): the lists
    stay in shared memory."""
    from demf_tpu_torch.tools import call_bytes, device_kernels
    shapes, value, locs, aw, grad = _f32_route_inputs(dev, b, q, p,
                                                      'whole map', 5)
    s = value.shape[1]
    assert msda.msda_rows_scratch_bytes(b, s, q, 8, 4, p, torch.float32) == 0
    before = msda.MSDA_BACKWARD_KERNEL.launches
    found = device_kernels(
        lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad), 4)
    assert msda.MSDA_BACKWARD_KERNEL.launches == before + 5
    assert sorted(found) == ['msda_backward_lists_kernel']
    taken = call_bytes(
        lambda: msda.msda_backward_cuda(value, shapes, locs, aw, grad))
    assert taken <= (value.numel() + locs.numel() + aw.numel()) * 4 + 2 ** 20


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['off the map', 'one place', 'edges',
                                   'whole map'])
@pytest.mark.parametrize('heads,hd,q,p', [(8, 32, 50, 4), (4, 16, 7, 3),
                                          (2, 8, 1, 1), (4, 4, 600, 2),
                                          (33, 32, 20, 2)])
def test_msda_backward_f32_route_matches_plain(dev, where, heads, hd, q, p):
    """Small float32 decoders on the lists route, as the bfloat16 row
    route's test takes them, with head_dims 4 to 32 and 33 heads (a token
    row of 1,056 channels): d_value equals the plain row order bit for bit
    and lies within 1e-5 of the plain autograd's largest, and so do d_loc
    and d_aw."""
    shapes = ((32, 48), (16, 24), (8, 12))
    assert msda.msda_rows_route(shapes, q, heads, 3, p, hd, torch.float32)
    value, locs, aw, grad = _msda_inputs(dev, shapes, 2, q, heads, hd, p,
                                         q + hd)
    if where == 'off the map':
        locs = locs - 1.5
    elif where == 'one place':
        locs[:] = torch.tensor([0.37, 0.58], device=dev)
    elif where == 'edges':
        locs = torch.round(locs * 4) / 4
    before = msda.MSDA_BACKWARD_KERNEL.launches
    got = msda.msda_backward_cuda(value, shapes, locs, aw, grad)
    assert msda.MSDA_BACKWARD_KERNEL.launches == before + 1
    assert torch.equal(got[0], msda.msda_backward_rows_plain(
        value, shapes, locs, aw, grad))
    if where == 'off the map':
        assert not got[0].any()
    ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
    want = torch.autograd.grad(
        msda.msda_plain(ins[0], shapes, ins[1], ins[2]), ins, grad)
    for g_, w in zip(got, want):
        assert (g_ - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize('what', ['tiles', 'entries', 'head_dim',
                                  'shared memory', 'grad_out'])
def test_msda_backward_f32_route_refuses_without_a_counted_launch(dev, what):
    """The float32 entry refuses the lists route with tiles, more than
    22,528 entries a (scene, head, level), a head_dim that is not a
    multiple of 4, a head's grad_out rows and entries beyond a block's
    shared memory (Q 1,408, P 4), or a grad_out off the 16-byte grid; a
    refused call counts no launch."""
    shapes = ((32, 48), (16, 24))
    s = sum(h * w for h, w in shapes)
    q = {'entries': 5633, 'shared memory': 1408}.get(what, 40)
    p = 4 if what == 'shared memory' else 1
    hd = 2 if what == 'head_dim' else 32
    value, locs, aw, grad = _msda_inputs(dev, shapes, 1, q, 2, hd, p, 0)
    info, tile_info = msda._tables(shapes, 32, True, dev)[:2]
    if what == 'grad_out':
        buf = torch.empty(grad.numel() + 1, dtype=grad.dtype, device=dev)
        grad = buf[1:].view(grad.shape)
    before = msda.MSDA_BACKWARD_KERNEL.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        msda.MSDA_BACKWARD_KERNEL(
            value.data_ptr(), info.data_ptr(), tile_info.data_ptr(),
            locs.data_ptr(), aw.data_ptr(), grad.data_ptr(),
            torch.empty_like(value).data_ptr(),
            torch.empty_like(locs).data_ptr(),
            torch.empty_like(aw).data_ptr(), 1, s, q, 2, hd, 2, p,
            1 if what == 'tiles' else 0, 0, 0, msda.msda_lists_parts(shapes))
    assert msda.MSDA_BACKWARD_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_msda_function_takes_its_inputs_as_they_come_under_autocast(
        dev, dtype):
    """``MSDAFunction`` under ``torch.autocast``: the value keeps its dtype
    (the output and d_value have it), the kernels of that dtype run, and
    the forward, d_loc and d_aw equal those outside autocast; d_value, whose
    sums K4 adds with atomics in no fixed order, within 1e-5 of its largest
    in float32 and one bf16 step in bf16."""
    shapes = ((32, 48), (16, 24), (8, 12))
    s = sum(h * w for h, w in shapes)
    value, locs, aw, grad = _msda_inputs(dev, shapes, 2, s, 4, 32, 4, 5)
    value, grad = value.to(dtype), grad.to(dtype)
    fwd = (msda.MSDA_KERNEL if dtype == torch.float32
           else msda.MSDA_BF16_KERNEL)
    runs = []
    for autocast in (False, True):
        ins = [t.clone().requires_grad_() for t in (value, locs, aw)]
        before = fwd.launches
        with torch.autocast('cuda', dtype=torch.bfloat16, enabled=autocast):
            out = msda.multi_scale_deformable_attention(ins[0], shapes,
                                                        ins[1], ins[2])
        out.backward(grad)
        assert fwd.launches == before + 1 and out.dtype == dtype
        runs.append([out.detach()] + [t.grad for t in ins])
    assert runs[0][1].dtype == dtype
    (out0, dv0, dl0, da0), (out1, dv1, dl1, da1) = runs
    assert torch.equal(out0, out1) and torch.equal(dl0, dl1)
    assert torch.equal(da0, da1)
    assert _within(dv1, dv0, 0.0,
                   1e-5 if dtype == torch.float32 else BF16_STEP)


@pytest.mark.cuda
def test_msda_kernels_refuse_other_dtypes(dev):
    """A float16 value, or bf16 locations, raise: no kernel takes them."""
    value, locs, aw, grad = _msda_inputs(dev, ((3, 4),), 1, 5, 2, 16, 2, 0)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        msda.msda_cuda(value.half(), ((3, 4),), locs, aw)
    with pytest.raises(TypeError, match='float32'):
        msda.msda_cuda(value.bfloat16(), ((3, 4),), locs.bfloat16(), aw)
    with pytest.raises(TypeError, match='bfloat16'):
        msda.msda_backward_cuda(value.bfloat16(), ((3, 4),), locs, aw, grad)


def _nms2d_inputs(dev, b, n, seed=0, **kwargs):
    from demf_tpu_torch.tools.nms_cases import nms2d_case
    return [torch.from_numpy(a).to(dev)
            for a in nms2d_case(b, n, seed=seed, **kwargs)]


@pytest.mark.cuda
@pytest.mark.parametrize('b', [2, 16])
@pytest.mark.parametrize('layout,n,thresh', [('rpn', 4390, 0.7),
                                             ('rcnn', 10000, 0.5)])
def test_nms2d_kernel_equals_plain_at_the_path_shapes(dev, b, layout, n,
                                                      thresh):
    """K10 against the plain version, keep masks equal bit for bit, on the
    RPN's 5 level groups and the R-CNN's 10 class groups; one launch a
    batch."""
    boxes, scores, idxs, valid = _nms2d_inputs(dev, b, n, seed=b,
                                               layout=layout)
    before = nms2d.NMS2D_KERNEL.launches
    got = nms2d.batched_nms_2d(boxes, scores, idxs, thresh, valid)
    assert nms2d.NMS2D_KERNEL.launches == before + 1
    want = nms2d.batched_nms_2d_plain(boxes, scores, idxs, thresh, valid)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize('n,groups', [(1, 1), (63, 2), (65, 1), (4096, 1),
                                      (5000, 3), (16384, 7)])
@pytest.mark.parametrize('options', [{}, dict(ties=True, degenerate=True,
                                              invalid=0.5)])
def test_nms2d_kernel_any_size_and_group_count(dev, n, groups, options):
    """One box, N around a tile's 64, one group over 4,096 boxes (a group
    past 32 words: the sweep's device-memory words), and the limit of
    16,384; tied scores, zero-area and identical boxes, invalid entries."""
    boxes, scores, idxs, valid = _nms2d_inputs(dev, 2, n, seed=n,
                                               groups=groups, **options)
    got = nms2d.batched_nms_2d(boxes, scores, idxs, 0.5, valid)
    want = nms2d.batched_nms_2d_plain(boxes, scores, idxs, 0.5, valid)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms2d_kernel_at_its_limit_and_any_int64_id(dev):
    """K10 at its limit of 16,384 candidates in 5 groups (one launch), and
    with ids the key cannot tell apart (equal low 16 bits, negative ids):
    its keep masks equal the plain version's."""
    boxes, scores, idxs, valid = _nms2d_inputs(dev, 2, 16384, seed=2,
                                               groups=5)
    before = nms2d.NMS2D_KERNEL.launches
    got = nms2d.batched_nms_2d(boxes, scores, idxs, 0.7, valid)
    assert nms2d.NMS2D_KERNEL.launches == before + 1
    assert torch.equal(got, nms2d.batched_nms_2d_plain(boxes, scores, idxs,
                                                       0.7, valid))
    boxes, scores, idxs, valid = _nms2d_inputs(dev, 2, 3000, seed=4,
                                               groups=4, ties=True)
    ids = torch.tensor([3, 3 + (1 << 16), -(1 << 16) + 3, -7],
                       device=dev)[idxs]
    got = nms2d.batched_nms_2d(boxes, scores, ids, 0.5, valid)
    want = nms2d.batched_nms_2d_plain(boxes, scores, ids, 0.5, valid)
    assert torch.equal(got, want)
    assert torch.equal(want, nms2d.batched_nms_2d_plain(boxes, scores, idxs,
                                                        0.5, valid))
    got = nms2d.batched_nms_2d(boxes, scores, idxs.int(), 0.5, valid)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms2d_kernel_non_finite_inputs(dev):
    boxes, scores, idxs, valid = _nms2d_inputs(dev, 2, 700, seed=9,
                                               groups=3)
    boxes[0, 3, 0] = float('nan')
    boxes[0, 9, 2] = float('inf')
    boxes[1, 4] = boxes[1, 5]
    boxes[1, 4, 1] = -float('inf')
    scores[1, 7] = float('nan')
    valid[1, 7] = True
    got = nms2d.batched_nms_2d(boxes, scores, idxs, 0.5, valid)
    assert torch.equal(got, nms2d.batched_nms_2d_plain(boxes, scores, idxs,
                                                       0.5, valid))


@pytest.mark.cuda
def test_nms2d_kernel_refuses_what_it_cannot_take(dev):
    """Over 16,384 candidates, another dtype, a CPU tensor handed to the
    CUDA entry: each raises before any launch."""
    before = nms2d.NMS2D_KERNEL.launches
    boxes, scores, idxs, valid = _nms2d_inputs(dev, 1, 16385)
    with pytest.raises(ValueError, match='at most 16384'):
        nms2d.batched_nms_2d(boxes, scores, idxs, 0.5, valid)
    boxes, scores, idxs, valid = _nms2d_inputs(dev, 2, 64)
    with pytest.raises(TypeError, match='boxes'):
        nms2d.batched_nms_2d(boxes.double(), scores, idxs, 0.5, valid)
    with pytest.raises(TypeError, match='scores'):
        nms2d.batched_nms_2d(boxes, scores.half(), idxs, 0.5, valid)
    with pytest.raises(TypeError, match='idxs'):
        nms2d.batched_nms_2d(boxes, scores, idxs.float(), 0.5, valid)
    with pytest.raises(ValueError, match='CUDA'):
        nms2d.batched_nms_2d_cuda(boxes.cpu(), scores, idxs, 0.5, valid)
    assert nms2d.NMS2D_KERNEL.launches == before


def _pyramid_inputs(dev, b, r, levels, c, seed=0):
    """NHWC levels, RoIs of every size (some across the borders and some
    beyond) and their levels by mmdet's rule."""
    gen = torch.Generator().manual_seed(seed)
    feats = tuple(torch.randn((b, h, w, c), generator=gen).to(dev)
                  for h, w in levels)
    img_h, img_w = levels[0][0] * 4, levels[0][1] * 4
    xy = torch.rand((b, r, 2), generator=gen) * torch.tensor(
        [img_w + 40.0, img_h + 40.0]) - 20
    wh = torch.exp(torch.rand((b, r, 2), generator=gen) * 6.5 + 0.5)
    rois = torch.cat([xy, xy + wh], -1).to(dev)
    return feats, rois, roi_align.roi_levels(rois, len(levels))


PATH_LEVELS = ((152, 208), (76, 104), (38, 52), (19, 26))


@pytest.mark.cuda
@pytest.mark.parametrize('b,r,levels,c', [
    (2, 1000, PATH_LEVELS, 256), (16, 1000, PATH_LEVELS, 256),
    (1, 37, ((16, 24), (8, 12), (4, 6), (2, 3)), 16),
    (3, 5, ((9, 7),), 4)])
def test_roi_align_kernel_equals_plain(dev, b, r, levels, c):
    """K11 against the plain version, equal bit for bit (the same
    roundings in the same order), so within 1e-5 of the largest output:
    the path's pyramid at batch 2 and 16, the tiny model's, one level; one
    launch a batch."""
    feats, rois, lvl = _pyramid_inputs(dev, b, r, levels, c, seed=b + r)
    strides = (4, 8, 16, 32)[:len(levels)]
    before = roi_align.ROI_ALIGN_KERNEL.launches
    got = roi_align.pyramid_roi_align(feats, rois, lvl, strides, 7)
    assert roi_align.ROI_ALIGN_KERNEL.launches == before + 1
    want = roi_align.pyramid_roi_align_plain(feats, rois, lvl, strides, 7)
    assert got.shape == (b, r, 7, 7, c)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('out_size,samples', [(7, 1), (7, 3), (5, 2),
                                              (14, 4)])
def test_roi_align_kernel_other_bins_and_samples(dev, out_size, samples):
    """K11's generic loop (samples other than 2) and other bin counts,
    equal to the plain version bit for bit, a channel slice and a part of
    one (C 132: 33 lanes of 16 bytes)."""
    feats, rois, lvl = _pyramid_inputs(dev, 2, 50, PATH_LEVELS[:3], 132,
                                       seed=out_size * samples)
    strides = (4, 8, 16)
    got = roi_align.pyramid_roi_align(feats, rois, lvl, strides, out_size,
                                      samples)
    want = roi_align.pyramid_roi_align_plain(feats, rois, lvl, strides,
                                             out_size, samples)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_roi_align_kernel_refuses_what_it_cannot_take(dev):
    feats, rois, lvl = _pyramid_inputs(dev, 2, 8, ((16, 24), (8, 12)), 8)
    before = roi_align.ROI_ALIGN_KERNEL.launches
    with pytest.raises(TypeError, match='float32'):
        roi_align.pyramid_roi_align(tuple(f.half() for f in feats),
                                    rois, lvl, (4, 8))
    with pytest.raises(TypeError, match='float32'):
        roi_align.pyramid_roi_align(feats, rois.double(), lvl, (4, 8))
    with pytest.raises(ValueError, match='multiple of 4'):
        roi_align.pyramid_roi_align(tuple(f[..., :6].contiguous()
                                          for f in feats), rois, lvl, (4, 8))
    with pytest.raises(ValueError, match='levels'):
        roi_align.pyramid_roi_align(feats * 3, rois, lvl, (4, 8) * 3)
    with pytest.raises(ValueError, match='out_size'):
        roi_align.pyramid_roi_align(feats, rois, lvl, (4, 8), 33)
    with pytest.raises(ValueError, match='CUDA'):
        roi_align.pyramid_roi_align_cuda(tuple(f.cpu() for f in feats),
                                         rois, lvl, (4, 8))
    assert roi_align.ROI_ALIGN_KERNEL.launches == before


def _grad_err(got, want):
    """max |kernel - plain| over the levels, and the largest plain value."""
    return (max((g - w).abs().max().item() for g, w in zip(got, want)),
            max(w.abs().max().item() for w in want))


@pytest.mark.cuda
@pytest.mark.parametrize('b,r,levels,c', [
    (2, 512, PATH_LEVELS, 256), (16, 512, PATH_LEVELS, 256),
    (1, 37, ((16, 24), (8, 12), (4, 6), (2, 3)), 16),
    (3, 5, ((9, 7),), 4)])
def test_roi_align_backward_kernel_matches_plain(dev, b, r, levels, c):
    """K12 against the plain version's autograd within 1e-5 of the
    largest gradient: the path's sampled RoIs at batch 2 and 16, the tiny
    model's pyramid, one level; one launch a backward, K11's forward
    launched once, through autograd of ``pyramid_roi_align``."""
    feats, rois, lvl = _pyramid_inputs(dev, b, r, levels, c, seed=b + r)
    strides = (4, 8, 16, 32)[:len(levels)]
    leaves = tuple(f.clone().requires_grad_() for f in feats)
    d_out = torch.randn((b, r, 7, 7, c), device=dev,
                        generator=torch.Generator(dev).manual_seed(r))
    fwd = roi_align.ROI_ALIGN_KERNEL.launches
    bwd = roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches
    out = roi_align.pyramid_roi_align(leaves, rois, lvl, strides, 7)
    got = torch.autograd.grad(out, leaves, d_out)
    assert roi_align.ROI_ALIGN_KERNEL.launches == fwd + 1
    assert roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches == bwd + 1
    assert torch.equal(out, roi_align.pyramid_roi_align_plain(
        feats, rois, lvl, strides, 7))
    want = roi_align.pyramid_roi_align_backward_plain(
        d_out, [f.shape for f in feats], rois, lvl, strides, 7)
    err, largest = _grad_err(got, want)
    assert err <= 1e-5 * largest


@pytest.mark.cuda
@pytest.mark.parametrize('samples', [1, 2, 3])
def test_roi_align_backward_kernel_clamped_borders(dev, samples):
    """RoIs across and beyond the map's borders and RoIs smaller than a
    pixel at its corners, whose corners clamp onto one pixel (which adds
    twice), with 1, 2 (unrolled) and 3 samples a bin axis, C 132 (a part
    of a channel slice)."""
    levels = ((16, 24), (8, 12))
    feats, rois, lvl = _pyramid_inputs(dev, 2, 40, levels, 132, seed=samples)
    rois[:, :6] = torch.tensor(
        [[-30.0, -30.0, 5.0, 5.0], [90.0, 60.0, 140.0, 110.0],
         [-5.0, 0.0, 0.5, 0.5], [95.5, 63.5, 96.0, 64.0],
         [-100.0, 10.0, -50.0, 30.0], [0.0, 0.0, 96.0, 64.0]], device=dev)
    lvl = roi_align.roi_levels(rois, 2)
    d_out = torch.randn((2, 40, 7, 7, 132), device=dev,
                        generator=torch.Generator(dev).manual_seed(7))
    got = roi_align.pyramid_roi_align_backward_cuda(
        d_out, [f.shape for f in feats], rois, lvl, (4, 8), 7, samples)
    want = roi_align.pyramid_roi_align_backward_plain(
        d_out, [f.shape for f in feats], rois, lvl, (4, 8), 7, samples)
    err, largest = _grad_err(got, want)
    assert err <= 1e-5 * largest


@pytest.mark.cuda
def test_roi_align_backward_refuses_rois_that_require_grad(dev):
    feats, rois, lvl = _pyramid_inputs(dev, 2, 8, ((16, 24), (8, 12)), 8)
    fwd = roi_align.ROI_ALIGN_KERNEL.launches
    bwd = roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches
    with pytest.raises(ValueError, match='RoIs take no gradient'):
        roi_align.pyramid_roi_align(feats, rois.requires_grad_(), lvl,
                                    (4, 8))
    d_out = torch.zeros((2, 8, 7, 7, 8), device=dev)
    with pytest.raises(ValueError, match='does not go with'):
        roi_align.pyramid_roi_align_backward_cuda(
            d_out[:1], [f.shape for f in feats], rois.detach(), lvl, (4, 8))
    assert roi_align.ROI_ALIGN_KERNEL.launches == fwd
    assert roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches == bwd


def _piled_inputs(dev, b, r, c, seed=0, box=(20.0, 16.0, 44.0, 40.0)):
    """The tiny pyramid of a 64x96 image and ``r`` RoIs a scene within a
    pixel of one box, so that one tile's list is long; their d_out."""
    levels = ((16, 24), (8, 12), (4, 6), (2, 3))
    gen = torch.Generator().manual_seed(seed)
    rois = (torch.tensor(box) + torch.rand((b, r, 4), generator=gen) * 2 -
            1).to(dev)
    d_out = torch.randn((b, r, 7, 7, c), generator=gen).to(dev)
    return d_out, [(b, h, w, c) for h, w in levels], rois, \
        roi_align.roi_levels(rois, len(levels))


@pytest.mark.cuda
@pytest.mark.parametrize('b,r,levels,c', [
    (2, 512, PATH_LEVELS, 256), (1, 37, ((16, 24), (8, 12), (4, 6), (2, 3)),
                                 16),
    (3, 5, ((9, 7),), 4), (2, 40, ((16, 24), (8, 12)), 132)])
def test_roi_align_backward_kernel_equals_tiles_plain(dev, b, r, levels, c):
    """K12 equal bit for bit to the plain version of its order: the path's
    sampled RoIs at batch 2, the tiny model's pyramid, one level, C 132 (a
    part of a channel slice); one launch a call."""
    feats, rois, lvl = _pyramid_inputs(dev, b, r, levels, c, seed=b + r)
    shapes = [f.shape for f in feats]
    strides = (4, 8, 16, 32)[:len(levels)]
    d_out = torch.randn((b, r, 7, 7, c), device=dev,
                        generator=torch.Generator(dev).manual_seed(r))
    before = roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches
    got = roi_align.pyramid_roi_align_backward_cuda(d_out, shapes, rois, lvl,
                                                    strides)
    assert roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches == before + 1
    want = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, strides)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['spread', 'piled'])
def test_roi_align_backward_kernel_same_bits_every_call(dev, kind):
    """Two calls of K12 give the same bits, on spread RoIs at the path's
    shape and on RoIs piled onto one box (lists cut into chunks)."""
    if kind == 'spread':
        feats, rois, lvl = _pyramid_inputs(dev, 2, 512, PATH_LEVELS, 256,
                                           seed=3)
        shapes = [f.shape for f in feats]
        d_out = torch.randn((2, 512, 7, 7, 256), device=dev)
        strides = (4, 8, 16, 32)
    else:
        d_out, shapes, rois, lvl = _piled_inputs(dev, 2, 400, 64, seed=3)
        strides = (4, 8, 16, 32)
    runs = [roi_align.pyramid_roi_align_backward_cuda(
        d_out, shapes, rois, lvl, strides) for _ in range(3)]
    for other in runs[1:]:
        assert all(torch.equal(g, o) for g, o in zip(runs[0], other))


@pytest.mark.cuda
@pytest.mark.parametrize('chunk,slots', [(512, None), (37, None), (16, 7),
                                         (5, 0)])
def test_roi_align_backward_kernel_splits_long_lists(dev, chunk, slots):
    """RoIs piled onto one box make lists longer than a chunk: each is cut
    into chunks summed apart and then in order (fewer chunks where the
    partial tiles would pass ``slots``; none at 0), equal bit for bit to
    the plain version of the same cut and within 1e-5 of the largest
    gradient of the plain autograd."""
    d_out, shapes, rois, lvl = _piled_inputs(dev, 2, 300, 20, seed=chunk)
    strides = (4, 8, 16, 32)
    kw = dict(chunk=chunk, slots=slots)
    got = roi_align.pyramid_roi_align_backward_cuda(d_out, shapes, rois, lvl,
                                                    strides, **kw)
    want = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, strides, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    autograd = roi_align.pyramid_roi_align_backward_plain(
        d_out, shapes, rois, lvl, strides)
    err, largest = _grad_err(got, autograd)
    assert err <= 1e-5 * largest
    lists = roi_align.k12_lists(shapes, rois, lvl, strides)
    assert int(lists['tile_n'].max()) > chunk


@pytest.mark.cuda
def test_roi_align_backward_kernel_writes_untouched_pixels_as_zero(dev):
    """The gradient's memory is not filled by the wrapper: after the card's
    allocator hands out memory that held NaN, every pixel that no corner
    reaches is exactly 0 and every other one equals the plain version."""
    feats, rois, lvl = _pyramid_inputs(dev, 2, 30, PATH_LEVELS, 64, seed=9)
    shapes = [f.shape for f in feats]
    d_out = torch.randn((2, 30, 7, 7, 64), device=dev)
    junk = torch.full((sum(int(np.prod(s)) for s in shapes) * 2,),
                      float('nan'), device=dev)
    del junk
    got = roi_align.pyramid_roi_align_backward_cuda(d_out, shapes, rois, lvl,
                                                    (4, 8, 16, 32))
    reached = roi_align.pyramid_roi_align_backward_plain(
        torch.ones_like(d_out), shapes, rois, lvl, (4, 8, 16, 32))
    untouched = sum(int((r == 0).sum()) for r in reached)
    assert untouched > 0
    for g, r in zip(got, reached):
        assert not torch.isnan(g).any()
        assert (g[r == 0] == 0).all()
    want = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, (4, 8, 16, 32))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize('levels', [((1, 1),), ((5, 3), (1, 1)),
                                    ((3, 7), (2, 4), (1, 2), (1, 1))])
@pytest.mark.parametrize('samples', [1, 2, 3])
def test_roi_align_backward_kernel_tiny_levels(dev, levels, samples):
    """A 1 x 1 level and levels smaller than one tile (every RoI clamped
    onto a few pixels), with 1, 2 (unrolled) and 3 samples a bin axis:
    equal to the plain version of K12's order, within 1e-5 of the plain
    autograd."""
    feats, rois, lvl = _pyramid_inputs(dev, 2, 20, levels, 8, seed=samples)
    shapes = [f.shape for f in feats]
    strides = (4, 8, 16, 32)[:len(levels)]
    d_out = torch.randn((2, 20, 7, 7, 8), device=dev)
    got = roi_align.pyramid_roi_align_backward_cuda(
        d_out, shapes, rois, lvl, strides, 7, samples)
    want = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, strides, 7, samples)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    err, largest = _grad_err(got, roi_align.pyramid_roi_align_backward_plain(
        d_out, shapes, rois, lvl, strides, 7, samples))
    assert err <= 1e-5 * largest


@pytest.mark.cuda
def test_roi_align_backward_kernel_counts_one_launch_a_backward(dev):
    """Autograd of ``pyramid_roi_align`` through K11 and K12 launches each
    wrapper once a call, whatever the kernels a call; no launch where the
    wrapper refuses."""
    feats, rois, lvl = _pyramid_inputs(dev, 2, 64, PATH_LEVELS[:2], 132,
                                       seed=4)
    leaves = tuple(f.clone().requires_grad_() for f in feats)
    fwd = roi_align.ROI_ALIGN_KERNEL.launches
    bwd = roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches
    for _ in range(2):
        out = roi_align.pyramid_roi_align(leaves, rois, lvl, (4, 8), 7)
        out.pow(2).sum().backward()
    assert roi_align.ROI_ALIGN_KERNEL.launches == fwd + 2
    assert roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches == bwd + 2
    with pytest.raises(ValueError, match='chunk'):
        roi_align.pyramid_roi_align_backward_cuda(
            torch.zeros((2, 64, 7, 7, 132), device=dev),
            [f.shape for f in feats], rois, lvl, (4, 8), chunk=0)
    assert roi_align.ROI_ALIGN_BACKWARD_KERNEL.launches == bwd + 2


# -- K11 / K12 on bf16 levels (the bf16 policy's FPN) -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('b,r,levels,c', [
    (2, 1000, PATH_LEVELS, 256), (16, 1000, PATH_LEVELS, 256),
    (16, 512, PATH_LEVELS, 256),
    (1, 37, ((16, 24), (8, 12), (4, 6), (2, 3)), 16),
    (3, 5, ((9, 7),), 4)])
def test_roi_align_bf16_kernel_equals_widened_levels_and_plain(dev, b, r,
                                                               levels, c):
    """K11's bf16 entry: float32 out, equal bit for bit to the float32
    kernel on the levels widened and to the plain version; one launch of
    the bf16 entry and none of the float32 one."""
    feats, rois, lvl = _pyramid_inputs(dev, b, r, levels, c, seed=b + r)
    feats = tuple(f.to(torch.bfloat16) for f in feats)
    strides = (4, 8, 16, 32)[:len(levels)]
    f32 = roi_align.ROI_ALIGN_KERNEL.launches
    before = roi_align.ROI_ALIGN_BF16_KERNEL.launches
    got = roi_align.pyramid_roi_align(feats, rois, lvl, strides, 7)
    assert roi_align.ROI_ALIGN_BF16_KERNEL.launches == before + 1
    assert roi_align.ROI_ALIGN_KERNEL.launches == f32
    assert got.dtype == torch.float32 and got.shape == (b, r, 7, 7, c)
    widened = tuple(f.float() for f in feats)
    assert torch.equal(got, roi_align.pyramid_roi_align_cuda(
        widened, rois, lvl, strides, 7))
    assert torch.equal(got, roi_align.pyramid_roi_align_plain(
        widened, rois, lvl, strides, 7))


@pytest.mark.cuda
@pytest.mark.parametrize('b,r,levels,c,chunk,slots', [
    (2, 512, PATH_LEVELS, 256, 256, None),
    (16, 512, PATH_LEVELS, 256, 256, None),
    (1, 37, ((16, 24), (8, 12), (4, 6), (2, 3)), 16, 256, None),
    (2, 40, ((16, 24), (8, 12)), 132, 16, 7)])
def test_roi_align_backward_bf16_kernel_equals_rounded_tiles_plain(
        dev, b, r, levels, c, chunk, slots):
    """K12's bf16 entry: bf16 gradients equal bit for bit to the plain
    version of its order rounded once (long lists cut into chunks whose
    float32 partial tiles are summed before the rounding, too), the same
    bits in two calls; through autograd of bf16 levels one launch of the
    bf16 entry and a bf16 gradient."""
    feats, rois, lvl = _pyramid_inputs(dev, b, r, levels, c, seed=b + r)
    strides = (4, 8, 16, 32)[:len(levels)]
    shapes = [f.shape for f in feats]
    d_out = torch.randn((b, r, 7, 7, c), device=dev,
                        generator=torch.Generator(dev).manual_seed(r))

    def kernel():
        return roi_align.pyramid_roi_align_backward_cuda(
            d_out, shapes, rois, lvl, strides, chunk=chunk, slots=slots,
            dtype=torch.bfloat16)

    got, again = kernel(), kernel()
    want = roi_align.pyramid_roi_align_backward_tiles_plain(
        d_out, shapes, rois, lvl, strides, chunk=chunk, slots=slots)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, a)
        assert torch.equal(g, w.to(torch.bfloat16))
    leaves = tuple(f.to(torch.bfloat16).requires_grad_() for f in feats)
    bwd = roi_align.ROI_ALIGN_BACKWARD_BF16_KERNEL.launches
    out = roi_align.pyramid_roi_align(leaves, rois, lvl, strides, 7)
    grads = torch.autograd.grad(out, leaves, d_out)
    assert roi_align.ROI_ALIGN_BACKWARD_BF16_KERNEL.launches == bwd + 1
    assert all(g.dtype == torch.bfloat16 for g in grads)
    if chunk == roi_align.K12_CHUNK and slots is None:
        assert all(torch.equal(g, k) for g, k in zip(grads, got))


@pytest.mark.cuda
def test_device_preprocess_on_the_card_equals_the_cpu(dev):
    """``data.device_pipeline``'s preprocess of one raw batch (uint8
    images of two sizes, clouds of 3,000 and 5,000 points in a cap of
    5,000) on the card and on the CPU from the same draws: images within
    1e-4, points, boxes and meta within 1e-5 (the card's cos, sin and
    float32 matrix products round their own way)."""
    from demf_tpu_torch.data import device_pipeline as dp
    cfg = [dict(type='LoadPointsFromFile', coord_type='DEPTH',
                shift_height=True, load_dim=6, use_dim=[0, 1, 2]),
           dict(type='LoadImageFromFile'),
           dict(type='LoadAnnotations3D'),
           dict(type='Resize', img_scale=(1333, 600), keep_ratio=True),
           dict(type='RandomFlip', flip_ratio=0.5),
           dict(type='Normalize', mean=[103.53, 116.28, 123.675],
                std=[1.0, 1.0, 1.0], to_rgb=False),
           dict(type='Pad', size_divisor=32),
           dict(type='RandomFlip3D', flip_ratio_bev_horizontal=0.5),
           dict(type='GlobalRotScaleTrans', rot_range=[-0.5, 0.5],
                scale_ratio_range=[0.85, 1.15], shift_height=True),
           dict(type='PointSample', num_points=4000)]
    spec = dp.DevicePreprocessSpec(cfg, points_cap=5000,
                                   raw_img_hw=(480, 640))
    rng = np.random.RandomState(0)
    raw = dict(raw_points=rng.uniform(-3, 3, (2, 5000, 3)).astype(np.float32),
               raw_points_count=np.array([3000, 5000], np.int32),
               raw_img=rng.randint(0, 256, (2, 480, 640, 3)).astype(np.uint8),
               raw_img_shape=np.array([[480, 640], [427, 561]], np.int32),
               gt_bboxes_3d=rng.uniform(-2, 2, (2, 8, 7)).astype(np.float32),
               gt_labels_3d=np.zeros((2, 8), np.int32),
               gt_valid=np.ones((2, 8), bool), img_meta={})
    cpu = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in raw.items()}
    preprocess = dp.make_device_preprocess(spec)
    want = preprocess(cpu, torch.Generator().manual_seed(0))
    # the same draws, in the order of ``dp.DRAW_ORDER`` from a generator of
    # the same seed, handed over (no translation: its std is 0)
    gen = torch.Generator().manual_seed(0)
    b = 2
    recorded = dict(flip2d=torch.rand(b, generator=gen) < 0.5,
                    flip3d=torch.rand(b, generator=gen) < 0.5,
                    angle=-0.5 + torch.rand(b, generator=gen),
                    scale=0.85 + 0.3 * torch.rand(b, generator=gen),
                    keys=torch.rand((b, 5000), generator=gen),
                    with_replacement=torch.rand((b, 4000), generator=gen))
    again = preprocess(cpu, None, draws=recorded)
    assert torch.equal(again['points'], want['points'])
    torch.backends.cuda.matmul.allow_tf32 = False
    got = preprocess({k: (v.to(dev) if torch.is_tensor(v) else v)
                      for k, v in cpu.items()}, None,
                     draws={k: v.to(dev) for k, v in recorded.items()})
    assert got['img'].is_cuda and got['img'].dtype == torch.float32
    assert (got['img'].cpu() - want['img']).abs().max() <= 1e-4 * \
        want['img'].abs().max()
    for key in ('points', 'gt_bboxes_3d'):
        assert torch.allclose(got[key].cpu(), want[key], atol=1e-5,
                              rtol=0), key
    for key, value in want['img_meta'].items():
        assert torch.allclose(got['img_meta'][key].cpu().float(),
                              value.float(), atol=1e-5, rtol=0), key


# -- K13 kernel map, K14 sparse conv, K15 class-wise rotated NMS -------------

def voxel_level(dev, b=2, n=20000, m=4096, stride=1, seed=0, spread=3.0):
    """Voxel tables of ``b`` clouds at 2 cm (capacity ``m``; a dense cloud
    overflows it), taken down to ``stride``; the last scene empty when
    ``b`` > 2."""
    from demf_tpu_torch.ops import sparse
    rng = np.random.RandomState(seed)
    pts = torch.from_numpy(rng.uniform(0, spread, (b, n, 3)).astype(
        np.float32)).to(dev)
    if b > 2:
        pts[-1] = -1.0                      # off the grid: no voxel
    coords, _, valid = sparse.voxelize(pts, pts, 0.02, (0.0, 0.0, 0.0), m)
    if stride > 1:
        coords, valid = sparse.downsample_coords(coords, valid, stride, m)
    return coords, valid


@pytest.mark.cuda
@pytest.mark.parametrize('presorted', [True, False, 'grouped'])
@pytest.mark.parametrize('k,stride', [(1, 1), (2, 2), (3, 1), (3, 4)])
@pytest.mark.parametrize('b,m,spread', [(3, 4096, 3.0), (1, 512, 0.3)])
def test_kernel_map_equals_plain(dev, b, m, spread, k, stride, presorted):
    """An empty scene, a scene at capacity (0.3 m of dense points), rows
    shuffled (the table sorted first), invalid query rows, and taps with
    no neighbour: the tables are equal.  ``grouped``: the level's table,
    its strided table onto the coarser level, that level's table, the
    pool's (the last axis fastest) and the transposed conv's back onto the
    level in one launch, each equal to the same table made alone and to
    the plain one."""
    from demf_tpu_torch.ops import sparse
    coords, valid = voxel_level(dev, b=b, m=m, stride=stride, spread=spread)
    if m == 512 and stride == 1:
        assert valid.all()
    if presorted == 'grouped':
        oc, ov = sparse.downsample_coords(coords, valid, 2 * stride,
                                          m // 2)
        jobs = [sparse.TableJob(coords, valid, coords, valid, k, True,
                                stride),
                sparse.TableJob(coords, valid, oc, ov, 2, True, stride),
                sparse.TableJob(oc, ov, oc, ov, 3, True, 2 * stride),
                sparse.TableJob(coords, valid, oc, ov, 2, False, stride),
                sparse.parent_job(coords, valid, oc, ov,
                                  tensor_stride=stride)]
        before = sparse.KERNEL_MAP_KERNEL.launches
        got = sparse.kernel_tables(jobs)
        assert sparse.KERNEL_MAP_KERNEL.launches == before + 1
        for job, table in zip(jobs, got):
            assert table.shape == (b, job.query_coords.shape[1],
                                   job.kernel_size ** 3)
            assert torch.equal(table, sparse.kernel_tables_cuda([job])[0])
            assert torch.equal(table, sparse.kernel_table_plain(job))
        assert torch.equal(got[0], sparse.kernel_map_cuda(
            *sparse.key_table_presorted(coords, valid), coords, valid,
            sparse.kernel_offsets(k, me_order=True, device=dev), stride))
        assert (got[4] >= 0).sum(-1).le(1).all() and (got[4] >= 0).any()
        return
    if not presorted:
        perm = torch.randperm(coords.shape[1], device=dev,
                              generator=torch.Generator(dev).manual_seed(k))
        coords, valid = coords[:, perm].contiguous(), \
            valid[:, perm].contiguous()
    table = (sparse.key_table_presorted if presorted else
             sparse.build_key_table)(coords, valid)
    offs = sparse.kernel_offsets(k, me_order=True, device=dev)
    before = sparse.KERNEL_MAP_KERNEL.launches
    got = sparse.kernel_map_cuda(*table, coords, valid, offs, stride)
    assert sparse.KERNEL_MAP_KERNEL.launches == before + 1
    want = sparse.kernel_map_plain(*table, coords, valid, offs, stride)
    assert torch.equal(got, want)
    if b > 2:
        assert (got[-1] == -1).all()
    assert (got >= 0).any() and ((got < 0).any() or k == 1)


def conv_table(dev, level, b, m, k):
    """A K14 input: (nbr (B, M_out, K), M_in, valid output rows).  Levels:
    ``spread`` (a 2 cm cloud, the last scene empty when ``b`` > 2),
    ``transposed`` (the decoder's table onto it: one tap a row at most),
    and ``tools/sparse_cases.py``'s ``cube`` (every tap inside exists),
    ``scattered`` (few taps a row) and ``distinct`` (a tap mask a row)."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools import sparse_cases
    if level in ('cube', 'scattered', 'distinct'):
        nbr, m_in = sparse_cases.level(dev, level, b, m, k)
        return nbr, m_in, torch.ones((b, m), dtype=torch.bool, device=dev)
    coords, valid = voxel_level(dev, b=b, m=m)
    if level == 'transposed':
        cc, cv = sparse.downsample_coords(coords, valid, 2, m // 2)
        return sparse.transposed_table(coords, valid, cc, cv,
                                       sorted_input=True), m // 2, valid
    return sparse_cases.level_table(coords, valid, k), m, valid


# (level, scenes, rows, C, C_out, K): the FCAF3D path's kinds of call and
# the levels the row plan meets
SPARSE_CONV_CASES = [
    ('spread', 3, 2048, 3, 64, 27), ('spread', 3, 2048, 64, 64, 27),
    ('spread', 3, 2048, 128, 256, 8), ('spread', 3, 2048, 16, 40, 1),
    ('spread', 3, 512, 512, 512, 27), ('spread', 2, 512, 512, 512, 27),
    ('cube', 2, 4096, 64, 64, 27), ('cube', 2, 512, 256, 256, 27),
    ('scattered', 3, 2048, 128, 128, 27),
    ('distinct', 2, 1024, 64, 128, 27),
    ('transposed', 3, 2048, 128, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('level,b,m,c,co,k', SPARSE_CONV_CASES)
def test_sparse_conv_equals_plain(dev, level, b, m, c, co, k, dtype):
    """Rows of an empty scene and past the valid prefix (all taps absent),
    taps with no neighbour, channels that no tile divides, a dense cube, a
    scattered level, a mask a row, one-tap rows, the tap split (layer 4's
    (512, 512, 27) at batch 2): float32 within 1e-5 of the largest output,
    bf16 within one bf16 step of it, against the plain version and against
    the plain walk of the plan in the kernel's order; the same bits on two
    calls, with the tap lists cut into parts of 1, 3 and all taps; rows
    with no tap exactly 0."""
    from demf_tpu_torch.ops import sparse
    nbr, m_in, valid = conv_table(dev, level, b, m, k)
    g = torch.Generator(dev).manual_seed(c + co)
    feats = torch.randn(b, m_in, c, device=dev, generator=g).to(dtype)
    w = (torch.randn(k, c, co, device=dev, generator=g) /
         (k * c) ** 0.5).to(dtype)
    kernel = (sparse.SPARSE_CONV_BF16_KERNEL if dtype == torch.bfloat16
              else sparse.SPARSE_CONV_KERNEL)
    plan = sparse.conv_plan(nbr)
    group = sparse.taps_a_part(b, m, c, co, k, dtype)
    if (level, b, m, c) == ('spread', 2, 512, 512):
        assert group < k
    before = kernel.launches
    got = sparse.sparse_conv_cuda(feats, nbr, w, plan)
    assert kernel.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, sparse.sparse_conv_cuda(feats, nbr, w, plan))
    want = sparse.sparse_conv_plain(feats, nbr, w).float()
    top = want.abs().max().item()
    tol = 1e-5 * top if dtype == torch.float32 else \
        2.0 ** (np.floor(np.log2(top)) - 7)
    walked = sparse.sparse_conv_tiles_plain(feats, nbr, w, plan,
                                            group).float()
    assert (walked - want).abs().max().item() <= tol
    assert (got.float() - want).abs().max().item() <= tol
    assert (got.float() - walked).abs().max().item() <= tol
    for other in {k, 1, 3} - {group}:
        again = sparse.sparse_conv_cuda(feats, nbr, w, plan, group=other)
        assert (again.float() - want).abs().max().item() <= tol
        assert torch.equal(again, sparse.sparse_conv_cuda(
            feats, nbr, w, plan, group=other))
    assert (got[plan.mask == 0] == 0).all()
    if level != 'distinct':
        assert (got[~valid] == 0).all()
    if b > 2 and level in ('spread', 'transposed'):
        assert (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize('level,b,m,k', [
    ('spread', 3, 2048, 27), ('spread', 2, 16384, 27), ('spread', 1, 20000, 8),
    ('cube', 2, 4096, 27), ('scattered', 2, 512, 27),
    ('distinct', 2, 1024, 27), ('transposed', 3, 2048, 8),
    ('spread', 2, 100, 1)])
def test_conv_plan_equals_plain(dev, level, b, m, k):
    """K14's plan kernel: masks, order (each scene's rows sorted stably by
    mask, in chunks of 16,384: a scene of 20,000 rows takes two) and tile
    taps equal to the plain plan's, at each of its block sizes."""
    from demf_tpu_torch.ops import sparse
    nbr = conv_table(dev, level, b, m, k)[0]
    before = sparse.SPARSE_CONV_PLAN_KERNEL.launches
    got = sparse.conv_plan(nbr)
    assert sparse.SPARSE_CONV_PLAN_KERNEL.launches == before + 1
    want = sparse.conv_plan_plain(nbr)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)


# K16's narrow tiles beside K14's cases: a one-tap conv's C_out 1 and 10
# (the head's centerness and classes), C 3 onto 8 (both sides narrow)
DWEIGHTS_CASES = SPARSE_CONV_CASES + [
    ('spread', 3, 2048, 128, 1, 1), ('spread', 3, 2048, 128, 10, 1),
    ('spread', 3, 2048, 3, 8, 27)]


@pytest.mark.cuda
@pytest.mark.parametrize('level,b,m,c,co,k', DWEIGHTS_CASES)
def test_sparse_dweights_equals_plain(dev, level, b, m, c, co, k):
    """K16 (the weight gradient) on K14's cases (the stem's C 3, one-tap
    and transposed tables, an empty scene, rows past the valid prefix) and
    its narrow tiles (C_out 1 and 10, C 3 onto 8), on float32 and on bf16
    rows and output gradient (each entry its own count; a bf16 product is
    exact in float32, so both are held alike): within 1e-5 of the largest
    against ``sparse_conv_dweights_plain``, the same bits on two calls, and
    the same sums with a tap's tiles in one block, in chunks of 7 and of
    its own size (``dweights_chunk``)."""
    from demf_tpu_torch.ops import sparse
    nbr, m_in, _ = conv_table(dev, level, b, m, k)
    gen = torch.Generator(dev).manual_seed(c + co + k)
    plan = sparse.conv_plan(nbr)
    for dtype, kernel in ((torch.float32, sparse.SPARSE_DWEIGHTS_KERNEL),
                          (torch.bfloat16,
                           sparse.SPARSE_DWEIGHTS_BF16_KERNEL)):
        feats = torch.randn(b, m_in, c, device=dev, generator=gen).to(dtype)
        g = torch.randn(b, nbr.shape[1], co, device=dev,
                        generator=gen).to(dtype)
        before = kernel.launches
        got = sparse.sparse_conv_dweights(feats, nbr, g, plan)
        assert kernel.launches == before + 1
        assert got.shape == (k, c, co) and got.dtype == torch.float32
        assert torch.equal(got, sparse.sparse_conv_dweights_cuda(
            feats, nbr, g, plan))
        want = sparse.sparse_conv_dweights_plain(feats, nbr, g)
        tol = 1e-5 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, dtype
        tiles = b * plan.tile_taps.shape[1]
        for chunk in (tiles, 7, sparse.dweights_chunk(b, nbr.shape[1], c, co,
                                                      k, dtype)):
            again = sparse.sparse_conv_dweights_cuda(feats, nbr, g, plan,
                                                     chunk)
            assert (again - want).abs().max().item() <= tol, (dtype, chunk)
            assert torch.equal(again, sparse.sparse_conv_dweights_cuda(
                feats, nbr, g, plan, chunk))


def backward_case(dev, kind):
    """(inputs on ``dev``, f(x, w) through the model's convolution of that
    table kind): a 2 cm cloud of 3 scenes (the last empty) at capacity
    2048, 16 -> 24 channels."""
    from demf_tpu_torch.ops import sparse
    coords, valid = voxel_level(dev, b=3, m=2048, stride=2)
    oc, ov = sparse.downsample_coords(coords, valid, 4, 1024)
    rng = np.random.RandomState(len(kind))
    k = {'submanifold': 27, 'strided': 8, 'stem': 27, 'shortcut': 1,
         'transposed': 8}[kind]
    rows = oc.shape[1] if kind == 'transposed' else coords.shape[1]
    x = torch.from_numpy(rng.randn(3, rows, 16).astype(np.float32)).to(dev)
    x = x * (ov if kind == 'transposed' else valid)[..., None]
    w = torch.from_numpy((rng.randn(k, 16, 24) / np.sqrt(16 * k)).astype(
        np.float32)).to(dev)

    def fn(xx, ww):
        if kind == 'submanifold':
            return sparse.submanifold_conv_batched(
                coords, valid, xx, ww, tensor_stride=2, sorted_input=True)
        if kind in ('strided', 'stem'):
            return sparse.strided_conv_batched(
                coords, valid, xx, ww, kernel_size=2 if k == 8 else 3,
                max_out=1024, tensor_stride=2, sorted_input=True)[2]
        if kind == 'shortcut':
            nbr = sparse.kernel_tables([sparse.TableJob(
                coords, valid, oc, ov, 2, True, 2)])[0]
            return sparse.sparse_conv_apply_batched(
                xx, nbr[..., :1], ww, rev=sparse.strided_reverse(
                    coords, valid, oc, ov, 2, 2, 2).taps(1))
        return sparse.transposed_conv_to_batched(
            coords, valid, oc, ov, xx, ww, tensor_stride=2,
            sorted_input=True)
    return (coords, valid, oc, ov), x, w, fn


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['submanifold', 'strided', 'stem',
                                  'shortcut', 'transposed'])
def test_sparse_conv_backward_equals_plain(dev, kind):
    """The autograd Function's backward on the card (K14 on the reverse
    table for d_feats, counted as ``sparse_conv_backward``, and K16)
    against its plain route on the CPU on the same inputs, in float32 and
    in float64 (the route ``gradcheck`` holds to finite differences,
    tests/test_torch_sparse_backward.py), within 1e-5 of each gradient's
    largest; the d_feats of invalid rows exactly 0."""
    from demf_tpu_torch.ops import sparse

    def grads(device, dtype):
        tables, x, w, fn = backward_case(device, kind)
        x = x.to(dtype).requires_grad_()
        w = w.to(dtype).requires_grad_()
        out = fn(x, w)
        ct = torch.from_numpy(np.random.RandomState(3).randn(
            *out.shape)).to(device, dtype)
        out.backward(ct)
        return tables, x.grad, w.grad

    before = (sparse.SPARSE_CONV_BACKWARD_KERNEL.launches,
              sparse.SPARSE_DWEIGHTS_KERNEL.launches)
    tables, dx, dw = grads(dev, torch.float32)
    assert sparse.SPARSE_CONV_BACKWARD_KERNEL.launches == before[0] + 1
    assert sparse.SPARSE_DWEIGHTS_KERNEL.launches == before[1] + 1
    for dtype in (torch.float32, torch.float64):
        _, want_x, want_w = grads(torch.device('cpu'), dtype)
        for got, want in ((dx, want_x), (dw, want_w)):
            want = want.double()
            err = (got.cpu().double() - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item(), (dtype, err)
    in_valid = tables[3] if kind == 'transposed' else tables[1]
    assert (dx[~in_valid] == 0).all()
    assert dw.abs().max() > 0 and dx.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['submanifold', 'strided', 'stem',
                                  'shortcut', 'transposed'])
def test_sparse_conv_backward_bf16_equals_plain(dev, kind):
    """The same backward under the bf16 policy (bf16 rows, weights and
    output gradient): K14's bf16 entry on the reverse table, counted as
    ``sparse_conv_backward_bf16``, and K16's bf16 entry, counted as
    ``sparse_conv_dweights_bf16``, against the plain route on the CPU on
    the same bf16 inputs: each a float32 sum rounded once to bf16, so
    within one bf16 step of each gradient's largest; bf16 gradients, the
    d_feats of invalid rows exactly 0."""
    from demf_tpu_torch.ops import sparse
    from demf_tpu_torch.tools.sparse_cases import tolerance

    def grads(device):
        tables, x, w, fn = backward_case(device, kind)
        x = x.bfloat16().requires_grad_()
        w = w.bfloat16().requires_grad_()
        out = fn(x, w)
        ct = torch.from_numpy(np.random.RandomState(3).randn(
            *out.shape)).to(device, torch.bfloat16)
        out.backward(ct)
        return tables, x.grad, w.grad

    kernels = (sparse.SPARSE_CONV_BACKWARD_BF16_KERNEL,
               sparse.SPARSE_DWEIGHTS_BF16_KERNEL,
               sparse.SPARSE_CONV_BACKWARD_KERNEL,
               sparse.SPARSE_DWEIGHTS_KERNEL)
    before = [k.launches for k in kernels]
    tables, dx, dw = grads(dev)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0]
    assert dx.dtype == dw.dtype == torch.bfloat16
    _, want_x, want_w = grads(torch.device('cpu'))
    for got, want in ((dx, want_x), (dw, want_w)):
        err = (got.cpu().float() - want.float()).abs().max().item()
        assert err <= tolerance(want, torch.bfloat16), err
    in_valid = tables[3] if kind == 'transposed' else tables[1]
    assert (dx[~in_valid] == 0).all()
    assert dw.abs().max() > 0 and dx.abs().max() > 0


# K15's IoU of a box and a copy of itself (the diagonal, and coincident
# boxes of other indices) against iou3d_matrix's at room coordinates: both
# versions cross parallel edges at denominators of rounding noise; up to
# 2.5e-6 seen on an H100 (chip_smoke.py, a FCAF3D request)
K15_COPY_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('n', [256, 64, 1])
@pytest.mark.parametrize('kind', ['spread', 'piled', 'coincident', 'apart',
                                  'aligned', 'stacked'])
def test_rotated_nms_equals_plain(dev, kind, n):
    """K15's IoUs within 1e-6 of ``iou3d_matrix``'s for two distinct boxes
    and within ``K15_COPY_TOL`` for a box and its copy, exactly 0 as the
    plain version's where two boxes cannot meet (circles apart, z-ranges
    apart: ``stacked``), its masks equal to the plain sweep fed its own
    IoUs bit for bit (NaN scores, scores below score_thr and invalid boxes
    take no part), the model path's masks (no IoU matrix asked for) equal
    to those and to calls on two streams at once, a scene whose boxes are
    all invalid keeps none, and one whose scores are all below score_thr
    keeps none."""
    from demf_tpu_torch.core.rotated_iou import iou3d_matrix
    from demf_tpu_torch.ops import nms_rotated
    from demf_tpu_torch.tools.nms_cases import (rotated_nms_case,
                                                rotated_pairs_apart)
    boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in
                            rotated_nms_case(kind, 3, n, seed=n))
    valid[-1] = False
    before = nms_rotated.NMS3D_ROTATED_KERNEL.launches
    iou = torch.full((3, n, n), float('nan'), device=dev)
    keep = nms_rotated.rotated_nms_classwise_cuda(boxes, scores, valid,
                                                  0.5, 0.01, iou)
    assert nms_rotated.NMS3D_ROTATED_KERNEL.launches == before + 1
    plain_iou = iou3d_matrix(boxes, boxes)
    err = (iou - plain_iou).abs()
    copies = (boxes[:, :, None] == boxes[:, None]).all(-1)
    if n > 1:
        assert err[~copies].max().item() <= 1e-6
    assert err[copies].max().item() <= K15_COPY_TOL
    apart = rotated_pairs_apart(boxes)
    assert (iou[apart] == 0).all() and (plain_iou[apart] == 0).all()
    if kind in ('apart', 'stacked') and n > 1:
        assert apart[~copies].all()
    want = nms_rotated.classwise_sweep(iou, scores, valid, 0.5, 0.01)
    assert torch.equal(keep, want)
    assert torch.equal(nms_rotated.rotated_nms_classwise_cuda(
        boxes, scores, valid, 0.5, 0.01), keep)
    # each call zeroes its own bits on its stream: calls on two streams at
    # once give the same masks
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            outs.append(nms_rotated.rotated_nms_classwise_cuda(
                boxes, scores, valid, 0.5, 0.01))
    torch.cuda.synchronize(dev)
    assert all(torch.equal(o, keep) for o in outs)
    assert not keep[-1].any() and (n == 1 or keep[:-1].any())
    assert not keep[:, 1, min(3, n - 1)].any()
    low = scores.clone()
    low[1] = 0.005
    none = nms_rotated.rotated_nms_classwise_cuda(boxes, low, valid, 0.5,
                                                  0.01)
    assert not none[1].any() and torch.equal(none[0], keep[0])


@pytest.mark.cuda
@pytest.mark.parametrize('n', [256, 64])
def test_rotated_nms_far_from_the_origin(dev, n):
    """Boxes out to 4 n m from the origin (``rotated_nms_case('far')``),
    each with a copy: corners R out carry roundings of R * 2**-23, which
    the shoelace sums of a box and its copy cancel into their IoU in both
    versions, so there the IoUs agree within 4 R 2**-23 over the smallest
    side (0.3 m); distinct boxes, which do not overlap, within 1e-6; the
    masks equal the plain sweep fed K15's IoUs bit for bit."""
    from demf_tpu_torch.core.rotated_iou import iou3d_matrix
    from demf_tpu_torch.ops import nms_rotated
    from demf_tpu_torch.tools.nms_cases import rotated_nms_case
    boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in
                            rotated_nms_case('far', 3, n, seed=n))
    iou = torch.empty((3, n, n), device=dev)
    keep = nms_rotated.rotated_nms_classwise_cuda(boxes, scores, valid,
                                                  0.5, 0.01, iou)
    err = (iou - iou3d_matrix(boxes, boxes)).abs()
    copies = (boxes[:, :, None] == boxes[:, None]).all(-1)
    reach = boxes[..., :2].abs().max().item()
    print(f'far (N {n}, out to {reach} m): distinct boxes '
          f'{err[~copies].max().item():.3e}, a box and its copy '
          f'{err[copies].max().item():.3e}')
    assert err[~copies].max().item() <= 1e-6
    assert err[copies].max().item() <= 4 * reach * 2.0 ** -23 / 0.3
    want = nms_rotated.classwise_sweep(iou, scores, valid, 0.5, 0.01)
    assert torch.equal(keep, want)


def pool_case(dev, b, m, seed=0):
    """A stem-like level on the card: b scenes of about m voxels at tensor
    stride 2 (the last scene holds fewer: padding rows), the stem pool's
    table onto its stride-4 set: (coords, valid, nbr, out valid)."""
    from demf_tpu_torch.ops import sparse
    rng = np.random.RandomState(seed)
    pts = torch.from_numpy(rng.uniform(0, 2.5, (b, 3 * m, 3)).astype(
        np.float32)).to(dev)
    pts[-1, m:] = -1.0                      # out of the grid: dropped
    coords, _, valid = sparse.voxelize(pts, torch.zeros_like(pts), 0.05,
                                       (0.0, 0.0, 0.0), m)
    coords, valid = sparse.downsample_coords(coords, valid, 2, m)
    oc, ov = sparse.downsample_coords(coords, valid, 4, max(1, m // 2))
    nbr = sparse.kernel_tables([sparse.TableJob(coords, valid, oc, ov, 2,
                                                False, 2)], True)[0]
    return coords, valid, nbr, ov


def pool_rows(valid, c, kind, dtype, seed=0):
    """Rows for K17: ``randn``; ``relu`` (zeros tie); ``ties`` (positive
    halves); ``nonfinite`` (NaN, inf, -inf and signed zeros among them)."""
    g = torch.Generator(valid.device).manual_seed(seed)
    x = torch.randn(*valid.shape, c, device=valid.device, generator=g)
    if kind == 'relu':
        x = x.clamp_min(0)
    elif kind == 'ties':
        x = ((x.abs() * 2).round() + 1) / 2
    elif kind == 'nonfinite':
        x[:, 10::7, 0] = float('nan')
        x[:, 11::7, c // 2] = float('inf')
        x[:, 12::7, c - 1] = float('-inf')
        x[:, 13::5] = 0.0
        x[:, 14::5] = -0.0
    return torch.where(valid[..., None], x, 0).to(dtype)


def bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['randn', 'relu', 'ties', 'nonfinite'])
@pytest.mark.parametrize('b,m,c', [(3, 16384, 64), (2, 2048, 5),
                                   (1, 512, 12)])
def test_sparse_max_pool_equals_plain(dev, b, m, c, kind, dtype):
    """K17's forward and backward (16-byte rows, and rows of 5 and 12
    values one a thread) against the plain versions of its order and
    against the chain and its autograd on the card, bit for bit: outputs,
    tie masks, reverse indices and d_in, -0 gradients written +0; one
    launch each, neither mask nor index in inference."""
    from demf_tpu_torch.ops import sparse
    coords, valid, nbr, ov = pool_case(dev, b, m)
    x = pool_rows(valid, c, kind, dtype)
    fwd = (sparse.SPARSE_MAX_POOL_KERNEL if dtype == torch.float32 else
           sparse.SPARSE_MAX_POOL_BF16_KERNEL)
    bwd = (sparse.SPARSE_MAX_POOL_BACKWARD_KERNEL if dtype == torch.float32
           else sparse.SPARSE_MAX_POOL_BACKWARD_BF16_KERNEL)
    before = (fwd.launches, bwd.launches)
    out, mask, reader = sparse.sparse_max_pool_cuda(x, nbr, ov)
    want, want_mask = sparse.sparse_max_pool_mask_plain(x, nbr, ov)
    assert torch.equal(bits(out), bits(want))
    assert torch.equal(mask, want_mask)
    assert written_equal(reader, sparse.sparse_max_pool_reader_plain(
        nbr, ov, x.shape[1]))
    bare, none, no_index = sparse.sparse_max_pool_cuda(x, nbr, ov,
                                                       with_mask=False)
    assert none is None and no_index is None
    assert torch.equal(bits(bare), bits(out))
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(1)).to(dtype)
    g[:, ::9] = -0.0
    d = sparse.sparse_max_pool_backward_cuda(g, reader, nbr, mask)
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(bits(d), bits(sparse.sparse_max_pool_backward_plain(
        g, nbr, mask, x.shape[1])))
    xa = x.clone().requires_grad_()
    chain = sparse.sparse_max_pool_plain(xa, nbr, ov)
    chain.backward(g)
    assert torch.equal(bits(chain.detach()), bits(out))
    assert torch.equal(bits(d), bits(xa.grad))
    if kind in ('relu', 'ties'):
        assert ((mask.int() & (mask.int() - 1)) > 0).any()
    xf = x.clone().requires_grad_()
    sparse.SparseMaxPool.apply(xf, nbr, ov).backward(g)
    assert torch.equal(bits(xf.grad), bits(d))
    assert (fwd.launches, bwd.launches) == (before[0] + 3, before[1] + 2)


@pytest.mark.cuda
def test_sparse_max_pool_refuses_other_kernels(dev):
    """K17 takes kernel == stride and at most 8 taps: other pools raise on
    the card before any table is made."""
    from demf_tpu_torch.ops import sparse
    coords, valid, _, _ = pool_case(dev, 1, 512)
    x = torch.zeros(*valid.shape, 8, device=dev)
    for k, s in ((3, 2), (2, 1), (3, 3)):
        with pytest.raises(ValueError):
            sparse.sparse_max_pool_batched(coords, valid, x, stride=s,
                                           kernel_size=k, tensor_stride=2,
                                           sorted_input=True)


def tie_table(dev, b, m_out, kind, c, dtype, seed=3):
    """Output row o reads input rows 8 o + t of 16 M_out (taps absent at
    random, all 8 present in every fifth row, a tenth of the output rows
    invalid; half the input rows have no reader) and rows of ``kind``:
    ``ties`` values of {1, 2} (ties of 2 to 8 taps), ``zeros`` of +0, -0
    and -1, ``nonfinite`` with NaN, inf and -inf planted.  Returns (rows,
    table, out_valid)."""
    rng = np.random.RandomState(seed)
    nbr = np.arange(m_out)[:, None] * 8 + np.arange(8)
    nbr = np.where(rng.rand(b, m_out, 8) < 0.4, -1, nbr)
    nbr[:, ::5] = np.arange(m_out)[::5, None] * 8 + np.arange(8)
    if kind == 'ties':
        x = rng.randint(1, 3, (b, 16 * m_out, c)).astype(np.float32)
    elif kind == 'zeros':
        x = rng.choice(np.array([0.0, -0.0, -1.0], np.float32),
                       (b, 16 * m_out, c))
    else:
        x = rng.randn(b, 16 * m_out, c).astype(np.float32)
        for col, v in enumerate((np.nan, np.inf, -np.inf)):
            x[:, col::13, col % c] = v
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(nbr.astype(np.int32)).to(dev),
            torch.from_numpy(rng.rand(b, m_out) > 0.1).to(dev))


def written_equal(reader, want):
    """K17's reverse index equals the plain one where that one names a
    reader (elsewhere the kernel writes nothing)."""
    read = want >= 0
    return torch.equal(reader[read], want[read])


def stale_entries(reader, want, nbr, ov, seed=4):
    """``reader`` with every entry that K17 does not write replaced by what
    stale memory may hold: any int around the table's range, and the taps
    of invalid output rows that do read the row."""
    m_out = nbr.shape[1]
    gen = torch.Generator(reader.device).manual_seed(seed)
    stale = torch.randint(-9, m_out * 8 + 9, reader.shape, generator=gen,
                          device=reader.device, dtype=torch.int32)
    s, o, t = torch.nonzero((nbr >= 0) & ~ov[..., None], as_tuple=True)
    stale[s, nbr[s, o, t].long()] = (o * 8 + t).int()
    return torch.where(want >= 0, reader, stale)


def stale_nan(dev, shape, dtype):
    """Leave a freed block of NaN of ``shape`` in the caching allocator,
    which the next allocation of that size takes: a kernel that does not
    write every element of it shows it."""
    torch.full(shape, float('nan'), dtype=dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['ties', 'zeros', 'nonfinite'])
@pytest.mark.parametrize('c', [64, 8, 5, 3])
def test_sparse_max_pool_ties_and_unread_rows(dev, c, kind, dtype):
    """K17 on ties of 2 to 8 taps, signed zeros and non-finite rows, with
    rows of 16 bytes and of 5 and 3 values (no multiple of 16 bytes, one
    value a thread): output, tie mask and reverse index equal to the plain
    versions, d_in to ``sparse_max_pool_backward_plain`` and to the chain's
    autograd bit for bit; each input row that no valid output reads comes
    out +0 though its memory held NaN before (no fill of d_in), and so it
    does with stale entries planted in the index where the forward wrote
    none."""
    from demf_tpu_torch.ops import sparse
    x, nbr, ov = tie_table(dev, 2, 1024, kind, c, dtype)
    m_in = x.shape[1]
    out, mask, reader = sparse.sparse_max_pool_cuda(x, nbr, ov)
    want, want_mask = sparse.sparse_max_pool_mask_plain(x, nbr, ov)
    assert torch.equal(bits(out), bits(want)) and torch.equal(mask, want_mask)
    want_reader = sparse.sparse_max_pool_reader_plain(nbr, ov, m_in)
    assert written_equal(reader, want_reader)
    if kind == 'ties':
        ties = {bin(v).count('1') for v in mask.unique().tolist()}
        assert set(range(2, 9)) <= ties
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(2)).to(dtype)
    g[:, ::7] = -0.0
    stale_nan(dev, x.shape, dtype)
    d = sparse.sparse_max_pool_backward_cuda(g, reader, nbr, mask)
    assert torch.equal(bits(d), bits(sparse.sparse_max_pool_backward_plain(
        g, nbr, mask, m_in)))
    again = sparse.sparse_max_pool_backward_cuda(
        g, stale_entries(reader, want_reader, nbr, ov), nbr, mask)
    assert torch.equal(bits(again), bits(d))
    unread = want_reader < 0
    assert unread.any() and (bits(d)[unread] == 0).all()
    xa = x.clone().requires_grad_()
    sparse.sparse_max_pool_plain(xa, nbr, ov).backward(g)
    assert torch.equal(bits(d), bits(xa.grad))


def slot_scene(dev, b, p, g, seed=0):
    """b scenes of p points (a (B, P, 4) cloud read through its strides)
    among g overlapping rotated boxes, a fifth of them invalid, a NaN point
    and a NaN box: points in 0 to many boxes."""
    rng = np.random.RandomState(seed)
    cloud = rng.uniform(-2, 2, (b, p, 4)).astype(np.float32)
    cloud[0, 3] = np.nan
    boxes = np.concatenate([
        rng.uniform(-1, 1, (b, g, 2)), rng.uniform(-1.2, -0.8, (b, g, 1)),
        rng.uniform(0.5, 2.5, (b, g, 2)), rng.uniform(2.0, 3.0, (b, g, 1)),
        rng.uniform(-np.pi, np.pi, (b, g, 1))], -1).astype(np.float32)
    boxes[-1, -1, 0] = np.nan
    valid = rng.rand(b, g) < 0.8
    return (torch.from_numpy(cloud).to(dev)[..., :3],
            torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev))


def check_vote_targets(points, boxes, valid, s):
    """K18 against its plain version on the card, bit for bit, in one
    launch, also through ``_vote_targets``; returns the masks."""
    from demf_tpu_torch.models import target_assign
    from demf_tpu_torch.ops import vote_targets as vt
    before = vt.VOTE_TARGETS_KERNEL.launches
    got, masks = vt.vote_targets_cuda(points, boxes, valid, s)
    assert vt.VOTE_TARGETS_KERNEL.launches == before + 1
    want, want_m = vt.vote_targets_plain(points, boxes, valid, s)
    assert torch.equal(bits(got), bits(want)) and torch.equal(masks, want_m)
    via = target_assign._vote_targets(points, boxes, valid, s)
    assert vt.VOTE_TARGETS_KERNEL.launches == before + 2
    assert torch.equal(bits(via[0]), bits(got)) and torch.equal(via[1],
                                                                masks)
    return masks


@pytest.mark.cuda
@pytest.mark.parametrize('b,p,g,s', [(16, 20000, 64, 3), (2, 1000, 5, 1),
                                     (3, 777, 200, 2), (2, 500, 8, 5),
                                     (1, 300, 1024, 8)])
def test_vote_slots_equals_plain(dev, b, p, g, s):
    """K18's vote targets and masks against the plain version on the card
    (the JAX package's expressions), bit for bit; one launch a call."""
    masks = check_vote_targets(*slot_scene(dev, b, p, g), s)
    assert masks.any() and not masks.all()


def face_scene(dev, yaw):
    """Points on and 2e-6 beyond the faces of boxes turned by ``yaw``
    (invalid boxes between valid ones, a NaN point, a NaN box)."""
    rng = np.random.RandomState(5)
    boxes = np.zeros((2, 6, 7), np.float32)
    boxes[..., :3] = rng.uniform(-1, 1, (2, 6, 3))
    boxes[..., 3:6] = rng.choice([0.5, 1.0, 1.5, 2.0], (2, 6, 3))
    boxes[..., 6] = yaw
    valid = np.tile([True, False, True, True, False, True], (2, 1))
    centers = boxes[..., :3].copy()
    centers[..., 2] += boxes[..., 5] / 2
    axis = rng.randint(0, 3, (2, 6, 40))
    off = rng.uniform(-0.5, 0.5, (2, 6, 40, 3)) * boxes[:, :, None, 3:6]
    face = np.take_along_axis(boxes[:, :, None, 3:6] / 2, axis[..., None], -1)
    face = face + np.where(rng.rand(2, 6, 40, 1) < 0.3, 2e-6, 0.0)
    np.put_along_axis(off, axis[..., None],
                      rng.choice([-1.0, 1.0], (2, 6, 40, 1)) * face, -1)
    c, s_ = np.cos(yaw), np.sin(yaw)
    off[..., :2] = np.stack([off[..., 0] * c + off[..., 1] * s_,
                             -off[..., 0] * s_ + off[..., 1] * c], -1)
    points = (centers[:, :, None] + off).reshape(2, 240, 3).astype(np.float32)
    points[0, 7] = np.nan
    boxes[1, 4, 0] = np.nan
    return (torch.from_numpy(points).to(dev), torch.from_numpy(boxes).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize('s', [1, 2, 3, 4])
@pytest.mark.parametrize('case', ['faces', 'turned', 'one_box', 'far_yaws'])
def test_vote_targets_edge_cases_equal_plain(dev, case, s):
    """K18 against its plain version, bit for bit, on points on and just
    beyond box faces (axis-aligned and turned boxes), invalid boxes
    between valid ones, NaN points and boxes, G = 1, and yaws out to
    +-1e4 rad (the kernel's cosf / sinf against torch.cos / torch.sin)."""
    if case in ('faces', 'turned'):
        scene = face_scene(dev, 0.0 if case == 'faces' else 0.7)
    else:
        points, boxes, valid = slot_scene(dev, 2, 3000, 40, seed=s)
        if case == 'one_box':
            boxes, valid = boxes[:, :1].contiguous(), valid[:, :1].clone()
            valid[0], valid[1] = True, False
        else:
            boxes[..., 6] = torch.linspace(-1e4, 1e4, boxes[..., 6].numel(),
                                           device=dev).view(boxes.shape[:2])
        scene = points, boxes, valid
    masks = check_vote_targets(*scene, s)
    assert masks.any()
