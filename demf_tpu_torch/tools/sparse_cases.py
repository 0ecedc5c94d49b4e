"""K14's inputs beside a FCAF3D request's own: voxel levels that the row
plan meets at the widths of MinkResNet34's layers, made on the card from a
seed, and the work a call computes.

* ``cube``: every voxel of a box of M voxels (sides powers of two): every
  tap inside it exists, so the plan saves nothing and the tensor cores
  carry every tap;
* ``scattered``: M distinct voxels drawn from a box eight times as large:
  about 4.25 taps a row (the centre and 26 / 8 neighbours);
* ``distinct``: a table whose every row has a tap mask of its own, its
  taps on random rows: no two rows can share a tile's list.

``calibrate_batch_norms`` gives a randomly initialised MinkResNet the
statistics of a batch, so that its features stay finite through 34
layers (a trained model's norms do as much).
"""
from __future__ import annotations

import math

import torch

# (level, scenes, rows a scene, C, C_out): layers 1, 3 and 4 of
# MinkResNet34 at a request's batch, on a dense cube and a scattered level
SPARSE_LEVELS = tuple((level, 2, m, c, c)
                      for level in ('cube', 'scattered')
                      for m, c in ((4096, 64), (1024, 256), (512, 512)))


def _box(m):
    """Sides (x, y, z), powers of two, of a box of m voxels."""
    e = m.bit_length() - 1
    if 1 << e != m:
        raise ValueError(f'a box of {m} voxels: take a power of two')
    return tuple(1 << (e // 3 + (1 if i < e % 3 else 0)) for i in range(3))


def _in_key_order(flat, sides):
    """Voxel numbers of a box (x slowest) -> int32 coords, in key order."""
    flat = flat.sort().values
    sy, sz = sides[1], sides[2]
    return torch.stack([flat // (sy * sz), flat // sz % sy, flat % sz],
                       -1).to(torch.int32)


def cube_level(dev, b, m):
    """Coords (B, M, 3) and valid (B, M) of a full box of M voxels."""
    sides = _box(m)
    coords = _in_key_order(torch.arange(m, device=dev), sides)
    return (coords[None].expand(b, -1, -1).contiguous(),
            torch.ones((b, m), dtype=torch.bool, device=dev))


def scattered_level(dev, b, m, seed=0):
    """Coords (B, M, 3) and valid (B, M): M distinct voxels a scene drawn
    from a box of 8 M (sides powers of two)."""
    sides = _box(8 * m)
    gen = torch.Generator(dev).manual_seed(seed)
    coords = torch.stack([
        _in_key_order(torch.randperm(8 * m, device=dev, generator=gen)[:m],
                      sides) for _ in range(b)])
    return coords, torch.ones((b, m), dtype=torch.bool, device=dev)


def level_table(coords, valid, k=27):
    """A level's submanifold table (K 27 or 8, MinkowskiEngine's order)."""
    from ..ops import sparse
    taps = {27: 3, 8: 2, 1: 1}[k]
    return sparse.neighbor_table_batched(
        coords, valid, coords, valid,
        sparse.kernel_offsets(taps, True, coords.device), sorted_input=True)


def distinct_table(dev, b, m, k=27, seed=0):
    """(B, M, K) int32: row i's mask is (i * 2654435761 + 1) mod 2^K (an
    odd multiplier: M distinct masks), each of its taps on a random row."""
    gen = torch.Generator(dev).manual_seed(seed)
    masks = (torch.arange(m, device=dev) * 2654435761 + 1) % (1 << k)
    bits = ((masks[:, None] >> torch.arange(k, device=dev)) & 1).bool()
    rows = torch.randint(0, m, (b, m, k), device=dev, generator=gen)
    return torch.where(bits, rows, -1).to(torch.int32)


def level(dev, kind, b, m, k=27):
    """(nbr, rows of the input table) of a ``cube``, ``scattered`` or
    ``distinct`` level."""
    if kind == 'distinct':
        return distinct_table(dev, b, m, k), m
    coords, valid = (cube_level if kind == 'cube' else scattered_level)(
        dev, b, m)
    return level_table(coords, valid, k), m


def conv_flops(nbr, plan, c, c_out):
    """(operations of the taps that exist, operations K14 computes on its
    tiles): 2 C C_out a (row, tap) with a neighbour; 2 x 64 rows x the
    depth each tile walks (its listed taps x C rounded up to 32 channels,
    or over the flat depth when C is not a multiple of 8) x C_out rounded
    up to 64."""
    from ..ops import sparse
    existing = 2.0 * int((nbr >= 0).sum()) * c * c_out
    bits = (plan.tile_taps[..., None] >> torch.arange(
        nbr.shape[2], device=nbr.device)) & 1
    taps = bits.sum(-1).double()
    d = sparse.CONV_TILE_DEPTH
    depth = taps * (-(-c // d) * d) if c % 8 == 0 else \
        torch.ceil(taps * c / d) * d
    cols = -(-c_out // sparse.CONV_TILE_COLS) * sparse.CONV_TILE_COLS
    return existing, 2.0 * sparse.CONV_TILE_ROWS * cols * float(depth.sum())


def calibrate_batch_norms(model, batch):
    """Random weights through MinkResNet34 with every BatchNorm at its
    identity grow without bound (exp of the regression overflows): give each
    ``MaskedBatchNorm`` the statistics of this batch's valid voxels, as a
    trained model's would normalize (one forward with only those norms in
    train mode, momentum 0).  Applied by the runs on the card, not by any
    config or entry."""
    from ..models.mink_resnet import MaskedBatchNorm
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.momentum = 0.0
        m.train()
    with torch.no_grad():
        model(batch)
    for m in norms:
        m.momentum = 0.9
        m.eval()
    return model


def tolerance(want, dtype):
    """K14's bound on |kernel - plain|: 1e-5 of the plain output's largest
    in float32 (another order of float32 sums), one bf16 step of it in
    bf16 (a float32 sum rounded once either way)."""
    top = max(want.float().abs().max().item(), 1e-30)
    return 1e-5 * top if dtype == torch.float32 else \
        2.0 ** (math.floor(math.log2(top)) - 7)


def gather_dweights(feats, nbr, g):
    """K16's yardstick: for each tap, the rows it reads gathered into (B *
    M_out, C) (zeros where absent) and one ``torch.matmul`` of their
    transpose with the output gradient (B * M_out, C_out).  Returns the
    call as a closure over its prepared indices."""
    b, m, c = feats.shape
    flat = torch.cat([feats.reshape(b * m, c), feats.new_zeros((1, c))])
    base = (torch.arange(b, device=nbr.device) * m)[:, None]
    idx = [torch.where(nbr[..., t] >= 0, nbr[..., t] + base, b * m).reshape(
        -1) for t in range(nbr.shape[2])]
    g2 = g.reshape(-1, g.shape[2])
    return lambda: [torch.matmul(flat[i].t(), g2) for i in idx]


def gather_matmul(feats, nbr, w):
    """K14's yardstick, one PyTorch call of each kind: the rows of every
    (row, tap) gathered into (B * M_out, K * C) (zeros where absent) and
    one ``torch.matmul`` with the (K * C, C_out) weights.  Returns the
    call as a closure over its prepared index."""
    b, m, c = feats.shape
    flat = torch.cat([feats.reshape(b * m, c), feats.new_zeros((1, c))])
    base = (torch.arange(b, device=nbr.device) * m)[:, None, None]
    idx = torch.where(nbr >= 0, nbr + base, b * m).reshape(-1)
    w2 = w.reshape(-1, w.shape[2])
    rows = b * nbr.shape[1]
    return lambda: torch.matmul(flat[idx].reshape(rows, -1), w2)


def gather_amax(feats, nbr, grad=None):
    """K17's yardstick, a time and not a result (``amax`` spreads a tie's
    gradient evenly, the chain halves it): the rows of every (row, tap)
    gathered into (B, M_out, K, C) (-inf where absent) and one
    ``torch.amax`` over the taps; with ``grad`` that call's autograd
    backward instead (the graph made once).  Returns the call as a
    closure over its prepared index."""
    b, m, c = feats.shape
    flat = torch.cat([feats.detach().reshape(b * m, c),
                      feats.new_full((1, c), float('-inf'))])
    base = (torch.arange(b, device=nbr.device) * m)[:, None, None]
    idx = torch.where(nbr >= 0, nbr + base, b * m).reshape(-1)
    shape = (*nbr.shape, c)
    if grad is None:
        return lambda: flat[idx].reshape(shape).amax(2)
    flat.requires_grad_()
    out = flat[idx].reshape(shape).amax(2)
    return lambda: torch.autograd.grad(out, flat, grad, retain_graph=True)


def pool_bytes(feats, nbr, out_valid, backward=False):
    """(Bytes the pool's function must move, bytes of K17's tie mask and
    reverse index).  The forward reads the rows its present taps point to,
    the table and out_valid, and writes the output; the backward reads the
    output gradient of the valid output rows, the table and out_valid, and
    writes d_in whole (a row no output reads is 0).  The mask, a byte a
    (output row, channel), and the reverse index, an int32 an input row,
    which the forward writes and the backward reads, are K17's design and
    not the function's: a cost apart."""
    b, m_out, _ = nbr.shape
    c, e = feats.shape[2], feats.element_size()
    table = 4 * nbr.numel() + out_valid.numel()
    if backward:
        need = int(out_valid.sum()) * c * e + table + feats.numel() * e
    else:
        need = int((nbr >= 0).sum()) * c * e + table + b * m_out * c * e
    return need, b * m_out * c + 4 * feats.shape[0] * feats.shape[1]
