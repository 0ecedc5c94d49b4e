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
@pytest.mark.parametrize('n,m,k,radius,extent', [
    (3000, 128, 16, 0.3, 1.0),
    (20000, 256, 64, 0.2, 3.0),
    # every point inside the radius: more candidates than the kernel's
    # shared-memory list holds, so the rounds rescan the point set
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
