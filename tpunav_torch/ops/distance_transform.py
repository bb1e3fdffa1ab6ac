"""Exact Euclidean distance transform for occupancy grids, batched.

Port of ``tpunav/ops/distance_transform.py`` (which replaces the
reference's fast-marching ESDF, bmapping/src/bmapping/grid_mapper.cpp:
333-435). The two-phase exact EDT over any leading batch dimensions:

1. per-column 1D distances by a down and an up sweep over the rows;
2. per-row exact lower envelope D(i,j)² = min_k (j-k)² + g(i,k)², taken
   as a loop over k so a batch of P maps needs no (P, H, W, W) temporary.

Every intermediate is a small integer held exactly in float32, so the
result does not depend on the order of the two phases or of the minima:
the map-update and EDT kernels (``csrc/map_update.cu``), which sweep rows
first, give the same field bit for bit.
"""

from __future__ import annotations

import torch


def column_distances(occ, big, dtype=torch.float32):
    """Per-column vertical distance (in cells) to the nearest occupied
    cell. occ: (..., H, W) bool. Returns (..., H, W) of ``dtype``."""
    init = torch.where(occ, 0.0, float(big)).to(dtype)
    h = init.shape[-2]
    down = torch.empty_like(init)
    up = torch.empty_like(init)
    carry = torch.full_like(init[..., 0, :], float(big))
    for i in range(h):
        carry = torch.minimum(init[..., i, :], carry + 1.0)
        down[..., i, :] = carry
    carry = torch.full_like(init[..., 0, :], float(big))
    for i in range(h - 1, -1, -1):
        carry = torch.minimum(init[..., i, :], carry + 1.0)
        up[..., i, :] = carry
    return torch.minimum(down, up)


def euclidean_distance_field(occ, resolution: float, max_dist: float,
                             dtype=torch.float32):
    """(..., H, W) distance in METERS to the nearest occupied cell, capped
    at ``max_dist`` (ref default max_occ_dist_=10.0, grid_mapper.cpp:49).
    Exact Euclidean metric."""
    h, w = occ.shape[-2:]
    g = column_distances(occ, h + w + 2.0, dtype)
    g2 = g * g
    j = torch.arange(w, device=occ.device, dtype=dtype)
    d2 = None
    for k in range(w):
        cand = (j - k) ** 2 + g2[..., k:k + 1]
        d2 = cand if d2 is None else torch.minimum(d2, cand)
    # A correctly rounded sqrt on every device, as the kernels' __fsqrt_rn
    # and XLA's: torch's float32 sqrt on the CPU can miss by an ulp
    # (sqrt(9225) gives 96.04685974, not 96.04686737). The float64 sqrt of
    # an exact integer, rounded once to float32, is correctly rounded
    # (53 ≥ 2·24 + 2 bits).
    d = torch.sqrt(d2.double()).to(dtype) * resolution
    return torch.clamp(d, max=max_dist)
