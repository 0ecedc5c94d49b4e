"""The quad-plane MSDA route: a level-concatenated plane whose row (y, x)
holds the whole 2x2 bilinear neighbourhood, one row gather per sample (K5)
and a weighted slot fold (K6).

Port of the encoder-scale forward of ``demf_tpu/ops/msda.py``
(``_build_quad_plane``, ``_geometry``, ``_slice_forward`` and
``_make_msda._fwd``, with ``_aw_lpq``'s transpose inline).  The TPU needs
this layout because its row gather is slow per row; on the card the
model's MSDA is K3, which reads the four corners itself.  This module is off the model path: it feeds real encoder
geometry to the probes of ``demf_tpu_torch.tools`` and is held against K3
by ``chip_smoke.py``.

What differs from the TPU route: the plane is built by shifts and a
concatenation (the TPU contracts shifted views with a 0/1 selector on its
matrix unit: the same values), the slices run in one launch each of K5 and
K6 (the TPU scans them, and chunks the queries), and the slot sum is K6's
loop (the TPU multiplies by a stacked identity, ``_fold_matrix``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .gather_rows import gather_rows
from .msda_fold import weighted_slot_fold_batched

# slot order (dy, dx): quad channel block slot * hd + j
SLOTS = ((0, 0), (0, 1), (1, 0), (1, 1))


def build_quad_plane(value, spatial_shapes):
    """value (B, sum_HW, heads, hd) -> quad plane (B, heads, sum_HW, 4*hd),
    quad[b, h, start_l + y*w + x] = concat(v[y, x], v[y, x+1], v[y+1, x],
    v[y+1, x+1]).

    Levels of at least 2 x 2 are built from flat row shifts (x+1 = shift 1,
    y+1 = shift w, zeros past the end), so row x = w-1 picks up the next
    image row: the geometry never gathers it (the quad base is clamped to
    x <= w-2).  A level narrower than 2 has no such base, and is built
    from the zero-padded grid, whose out-of-grid slots are zeros.
    """
    b, _, heads, hd = value.shape
    planes = []
    start = 0
    for h, w in spatial_shapes:
        n = h * w
        v = value[:, start:start + n]                     # (B, n, heads, hd)
        if h < 2 or w < 2:
            grid = v.permute(0, 2, 1, 3).reshape(b, heads, h, w, hd)
            grid = F.pad(grid, (0, 0, 0, 1, 0, 1))
            quad = torch.cat([grid[:, :, dy:dy + h, dx:dx + w]
                              for dy, dx in SLOTS], -1)
        else:
            flat = F.pad(v, (0, 0, 0, 0, 0, w + 1))
            quad = torch.stack([flat[:, dy * w + dx:dy * w + dx + n]
                                for dy, dx in SLOTS], 3)  # (B,n,heads,4,hd)
            quad = quad.permute(0, 2, 1, 3, 4)
        planes.append(quad.reshape(b, heads, n, 4 * hd))
        start += n
    return torch.cat(planes, 2)


def geometry(spatial_shapes, locs):
    """Sample geometry in lp-major, Q-minor layout.

    locs (B, Q, heads, L, P, 2) in [0, 1] -> dict of (B, heads, L, P, Q)
    tensors: ``idx`` (int32 row of the quad plane at the clamped quad base)
    and ``ws`` (the four slots' bilinear weights, in ``SLOTS`` order).  A
    slot more than one pixel from the sample has weight 0, which gives the
    zero padding.
    """
    nlv = locs.shape[3]
    t = locs.permute(0, 2, 3, 4, 5, 1).contiguous()      # (B,h,L,P,2,Q)

    def per_level(vals):
        return torch.tensor(vals, dtype=torch.float32,
                            device=locs.device).reshape(1, 1, nlv, 1, 1)

    wvec = per_level([w for _, w in spatial_shapes])
    hvec = per_level([h for h, _ in spatial_shapes])
    starts = [0]
    for h, w in spatial_shapes:
        starts.append(starts[-1] + h * w)
    svec = per_level(starts[:-1])
    wm2 = per_level([max(w - 2, 0) for _, w in spatial_shapes])
    hm2 = per_level([max(h - 2, 0) for h, _ in spatial_shapes])
    x = t[:, :, :, :, 0] * wvec - 0.5
    y = t[:, :, :, :, 1] * hvec - 0.5
    bx = torch.minimum(torch.floor(x).clamp(min=0.0), wm2)
    by = torch.minimum(torch.floor(y).clamp(min=0.0), hm2)
    idx = svec + by * wvec + bx
    ws = [torch.relu(1.0 - (x - (bx + dx)).abs()) *
          torch.relu(1.0 - (y - (by + dy)).abs()) for dy, dx in SLOTS]
    return dict(idx=idx.to(torch.int32), ws=ws)


def slice_forward(plane, idx, w4, q):
    """Every (b, h) slice at once: plane (BH, N, 4*hd), idx (BH, LP*Q)
    int32 lp-major, w4 (BH, LP*Q, 4) attention times bilinear weights ->
    (BH, Q, hd) float32.  One K5 launch gathers every sample's quad row,
    one K6 launch folds them."""
    bh, _, c4 = plane.shape
    lp = idx.shape[1] // q
    rows = gather_rows(plane, idx).view(bh, lp, q, c4)
    return weighted_slot_fold_batched(rows, w4.view(bh, lp, q, 4),
                                      hd=c4 // 4)


def msda_quad_forward(value, spatial_shapes, sampling_locations,
                      attention_weights):
    """MSDA forward through the quad plane: value (B, sum_HW, heads, hd),
    sampling_locations (B, Q, heads, L, P, 2), attention_weights
    (B, Q, heads, L, P) -> (B, Q, heads * hd) in value's dtype.

    The plane keeps value's dtype and the sums are float32.  On CUDA
    tensors this launches K5 and K6 once each; on CPU tensors their plain
    versions run.
    """
    b, _, heads, hd = value.shape
    q = sampling_locations.shape[1]
    plane = build_quad_plane(value, spatial_shapes)
    plane = plane.reshape(b * heads, -1, 4 * hd)
    geo = geometry(spatial_shapes, sampling_locations)
    aw_t = attention_weights.permute(0, 2, 3, 4, 1)      # (B,h,L,P,Q)
    w4 = torch.stack([w * aw_t for w in geo['ws']], -1)  # (B,h,L,P,Q,4)
    out = slice_forward(plane, geo['idx'].reshape(b * heads, -1),
                        w4.reshape(b * heads, -1, 4), q)
    out = out.view(b, heads, q, hd).permute(0, 2, 1, 3)
    return out.reshape(b, q, heads * hd).to(value.dtype)
