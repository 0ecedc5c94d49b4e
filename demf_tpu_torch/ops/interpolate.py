"""Three-NN inverse-distance feature propagation (plain torch).

Port of ``demf_tpu/ops/interpolate.py``.  The source sets are small
(<= 512 points), so a dense distance matrix and a top-3 suffice.
"""
from __future__ import annotations

import torch

from .grouping import sqdist


def three_nn_interpolate(unknown, known, features):
    """unknown (B, N, 3), known (B, M, 3), features (B, M, C) -> (B, N, C).

    Weights are (1/d2) / sum(1/d2) with the CUDA op's 1e-8 epsilon.
    """
    d2 = sqdist(unknown.float(), known.float())
    neg, idx = torch.topk(-d2, 3, dim=-1)
    dist_recip = 1.0 / (neg.neg().clamp_min(0.0) + 1e-8)
    weight = dist_recip / dist_recip.sum(-1, keepdim=True)
    b, n, _ = idx.shape
    gathered = torch.gather(
        features, 1, idx.reshape(b, n * 3, 1).expand(-1, -1,
                                                     features.shape[-1]))
    gathered = gathered.reshape(b, n, 3, features.shape[-1])
    return (gathered * weight[..., None].to(features.dtype)).sum(2)
