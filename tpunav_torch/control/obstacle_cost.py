"""Obstacle-avoidance cost fields for MPPI (BASELINE config 2).

Port of ``tpunav/control/obstacle_cost.py``. Each of the K×N rollout
positions pays

    cost(p) = w_hit·[d(p) ≤ r_safe] + w_field·exp(−(d(p) − r_safe)/σ)

where d(p) is either a bilinear lookup in an ESDF of the planning grid
(:func:`make_obstacle_cost`, the plain solver's ``extra_cost``) or the
closed-form distance to segment and circle primitives
(:func:`make_segment_obstacle_cost`), which the fused kernel K1 evaluates
in-kernel (``ops/fused_mppi.py``, obstacle mode).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ..ops.distance_transform import euclidean_distance_field


@dataclasses.dataclass(frozen=True)
class ObstacleCostConfig:
    xmin: float
    ymin: float
    resolution: float
    r_safe: float = 0.12          # robot bounding radius
    w_hit: float = 1e6            # collision penalty
    w_field: float = 1e3          # decay-field weight
    sigma: float = 0.2            # decay length (meters)


def distance_field_from_labels(labels, resolution: float,
                               max_dist: float = 10.0,
                               device=DEFAULT_DEVICE):
    """(H, W) float32 ESDF of a planning grid's labels (OBSTACLE == 1 cells
    are seeds; inflated cells are handled by r_safe instead)."""
    occ = torch.as_tensor(np.asarray(labels) == 1, device=resolve(device))
    return euclidean_distance_field(occ, resolution, max_dist,
                                    dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class SegmentCostParams:
    """Weights of the analytic primitive-set obstacle cost (the cost law of
    :class:`ObstacleCostConfig`, with d(p) in closed form against segment
    and circle primitives instead of a grid lookup)."""

    r_safe: float = 0.12
    w_hit: float = 1e6
    w_field: float = 1e3
    sigma: float = 0.2


def segments_from_circles(centers, radii, device=DEFAULT_DEVICE):
    """Circle obstacles as degenerate (a == b) offset segments: (O, 5)
    float32 rows [ax, ay, bx, by, r]."""
    dev = resolve(device)
    c = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    r = torch.as_tensor(radii, dtype=torch.float32, device=dev).reshape(-1, 1)
    return torch.cat([c, c, r], dim=1)


def segments_from_polygons(polygons, device=DEFAULT_DEVICE):
    """Polygon obstacles (the planner's obstacle-map format) as their edge
    segments with zero offset radius: (O, 5) float32 rows."""
    rows = []
    for poly in polygons:
        n = len(poly)
        for i in range(n):
            a, b = poly[i], poly[(i + 1) % n]
            rows.append([a[0], a[1], b[0], b[1], 0.0])
    return torch.tensor(rows, dtype=torch.float64).to(
        device=resolve(device), dtype=torch.float32)


def make_segment_obstacle_cost(params: SegmentCostParams, segments,
                               device=DEFAULT_DEVICE):
    """Returns ``cost_fn(xy) -> cost`` for (..., 2) positions against (O, 5)
    segment primitives [ax, ay, bx, by, r]: d(p) = min over primitives of
    (point-to-segment distance − r). The arithmetic is ``tpunav``'s, op for
    op (the λ=0.01 softmax turns last-ulp cost differences into e^(100Δ)
    weight ratios); it adds w_hit·hit and w_field·e as one term, where the
    fused kernel adds them to the loss one after the other."""
    segments = torch.as_tensor(segments, dtype=torch.float32,
                               device=resolve(device))
    a = segments[:, 0:2]                        # (O, 2)
    ab = segments[:, 2:4] - a                   # (O, 2)
    rr = segments[:, 4]                         # (O,)
    n2 = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)
    inv = torch.ones_like(n2) / n2              # tensor / tensor: a division
    inv_sigma = float(np.float32(1.0 / params.sigma))   # kernel-identical

    def cost_fn(xy):
        ap = xy[..., None, :] - a               # (..., O, 2)
        t = torch.clamp(torch.sum(ap * ab, dim=-1) * inv, 0.0, 1.0)
        proj = a + t[..., None] * ab
        diff = xy[..., None, :] - proj
        d = torch.sqrt(torch.sum(diff * diff, dim=-1)) - rr
        d = torch.amin(d, dim=-1)
        hit = (d <= params.r_safe).to(d.dtype)
        return params.w_hit * hit + params.w_field * torch.exp(
            -(d - params.r_safe) * inv_sigma)

    return cost_fn


def make_obstacle_cost(cfg: ObstacleCostConfig, dist_field):
    """Returns ``cost_fn(xy) -> cost`` for (..., 2) world positions, a
    bilinear lookup in the (H, W) ``dist_field``; suitable as
    ``mppi_solve``'s extra running cost."""
    h, w = dist_field.shape

    def cost_fn(xy):
        fx = (xy[..., 0] - cfg.xmin) / cfg.resolution - 0.5
        fy = (xy[..., 1] - cfg.ymin) / cfg.resolution - 0.5
        x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 2)
        y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 2)
        tx = torch.clamp(fx - x0, 0.0, 1.0)
        ty = torch.clamp(fy - y0, 0.0, 1.0)
        d00 = dist_field[y0, x0]
        d01 = dist_field[y0, x0 + 1]
        d10 = dist_field[y0 + 1, x0]
        d11 = dist_field[y0 + 1, x0 + 1]
        d = (d00 * (1 - tx) * (1 - ty) + d01 * tx * (1 - ty) +
             d10 * (1 - tx) * ty + d11 * tx * ty)
        hit = (d <= cfg.r_safe).to(d.dtype)
        return cfg.w_hit * hit + cfg.w_field * torch.exp(
            -(d - cfg.r_safe) / cfg.sigma)

    return cost_fn
