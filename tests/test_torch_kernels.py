"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX.)  Without a card
every test here skips.
"""
import numpy as np
import pytest
import torch

from demf_tpu_torch.ops import (gather_rows, grouping, mform, msda, msda_fold,
                                sampling)


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
def test_msda_fold_kernel_matches_plain(dev, dtype, layout):
    """K6 with weights (BH, LP, Q, 4) and, read through their strides,
    slot-major (BH, LP, 4, Q); within 1e-5 of the largest output (both
    sides round alike, so in practice bit-equal)."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randn(2, 16, 300, 128, device=dev, generator=g).to(dtype)
    if layout == 'slot_major':
        w = torch.rand(2, 16, 4, 300, device=dev, generator=g)
        got = msda_fold.slot_major_fold(rows, w)
        w = w.transpose(2, 3)
    else:
        w = torch.rand(2, 16, 300, 4, device=dev, generator=g)
        got = msda_fold.weighted_slot_fold_batched(rows, w, hd=32)
        w = w.to(dtype)
    want = msda_fold.slot_fold_plain(rows, w)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
