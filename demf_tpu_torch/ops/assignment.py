"""Linear assignment for the DETR matcher: the on-device auction and the
host Hungarian solve (port of ``demf_tpu/ops/assignment.py`` and of
``demf_tpu/models/detr_head.py::hungarian_match``).

The auction is a parallel (Jacobi) forward auction [Bertsekas 1988] in
plain tensor ops, batched over images: every problem of the batch takes the
same steps at once, and a step is the identity for a problem whose rows are
all assigned, so the batched loop needs no masks.  Whether any row is still
unassigned is read on the host only every ``check_every`` steps.  Total
cost within ``G * eps`` of optimal; the two precision rules of the JAX
package hold here too: the epsilon scale comes from REAL entries only
(padding rows carry a 1e6 sentinel that would inflate it), and the sentinel
is clamped to unit scale before the solve (float32 nets at 1e6 quantize at
~0.06).  Ties go to the lowest index, as ``jax.lax.top_k`` and ``argmax``
break them, so both packages assign alike.

Shapes: (G rows = padded gt) x (Q columns = queries), G <= Q.  Padding rows
carry a constant cost >= 1e5.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def auction_phase(values, prices, eps, max_iters=50000, check_every=8):
    """All rows start unassigned.  values (B, G, Q) to maximize, prices
    (B, Q), eps (B,) -> (assigned column (B, G) int64, prices, steps run;
    the steps are counted in multiples of ``check_every`` once past it)."""
    b, g, q = values.shape
    rows = torch.arange(g, device=values.device)
    assigned = torch.full((b, g), -1, dtype=torch.long, device=values.device)
    neg = values.new_full((), NEG)
    steps = 0
    while steps < max_iters:
        if steps % check_every == 0 and not bool((assigned < 0).any()):
            break
        unassigned = assigned < 0                              # (B, G)
        net = values - prices[:, None, :]                      # (B, G, Q)
        best_v, best_j = net.max(-1)
        second_v = net.scatter(-1, best_j[..., None],
                               float('-inf')).max(-1).values
        bids = prices.gather(1, best_j) + (best_v - second_v) + eps[:, None]
        # per-column winner among the bidding (unassigned) rows
        bidmat = values.new_full((b, g, q), NEG).scatter_(
            2, best_j[..., None], torch.where(unassigned, bids,
                                              neg)[..., None])
        col_best, col_winner = bidmat.max(1)                   # (B, Q)
        has_bid = col_best > NEG / 2
        prices = torch.where(has_bid, col_best, prices)
        # a row that holds a re-auctioned column loses it
        evicted = has_bid.gather(1, assigned.clamp(0, q - 1)) & ~unassigned
        assigned = torch.where(evicted, -1, assigned)
        won = has_bid.gather(1, best_j) & unassigned & \
            (col_winner.gather(1, best_j) == rows)
        assigned = torch.where(won, best_j, assigned)
        steps += 1
    # rows still unassigned at max_iters take their best column, whoever
    # holds it (keeps the result well-formed; the bound is far above what
    # convergence takes)
    fallback = (values - prices[:, None, :]).argmax(-1)
    return torch.where(assigned < 0, fallback, assigned), prices, steps


def auction_assign(cost, eps_frac=0.002, max_iters=50000, check_every=8,
                   return_steps=False):
    """Minimize ``sum_i cost[i, col_i]`` over distinct columns for each
    problem of a batch.  cost (B, G, Q), G <= Q; entries >= 1e5 are padding
    sentinels.  ``eps_frac`` is the suboptimality budget as a share of the
    real cost range.  -> (B, G) int64 assigned column per row (and the
    steps run with ``return_steps``)."""
    b, g, q = cost.shape
    cost = cost.float()
    real = cost < 1e5
    inf = cost.new_full((), float('inf'))
    any_real = real.flatten(1).any(1)
    cmax = torch.where(real, cost, -inf).flatten(1).max(1).values
    cmin = torch.where(real, cost, inf).flatten(1).min(1).values
    one = cost.new_ones(())
    rng = torch.where(any_real, (cmax - cmin).clamp_min(1e-6), one)
    # sentinels at unit scale, strictly worse than any real entry: padding
    # rows stay uniform, so the real rows' optimum is unchanged
    sentinel = torch.where(any_real, cmax + rng + 1.0, one)
    cost = torch.where(real, cost, sentinel[:, None, None])
    assigned, _, steps = auction_phase(
        -cost, cost.new_zeros((b, q)), rng * eps_frac / g, max_iters,
        check_every)
    return (assigned, steps) if return_steps else assigned


def auction_match(cost):
    """(B, Q, G) costs -> (B, G) int64: for each gt column the assigned
    query row.  Same contract as ``hungarian_match``."""
    return auction_assign(cost.transpose(1, 2))


def hungarian_match(cost):
    """The optimal assignment through scipy on the host: (B, Q, G) costs
    (padding columns at a large constant) -> (B, G) int64 on ``cost``'s
    device.  One copy to the host and one back for the whole batch."""
    from scipy.optimize import linear_sum_assignment
    c = cost.detach().cpu().numpy()
    out = np.zeros((c.shape[0], c.shape[2]), np.int64)
    for i in range(c.shape[0]):
        row, col = linear_sum_assignment(c[i])
        out[i, col] = row
    return torch.from_numpy(out).to(cost.device)
