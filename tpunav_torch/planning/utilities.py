"""Line-segment / point geometry primitives (batched torch).

Port of ``tpunav/planning/utilities.py`` (a re-design of
planner/src/planner/planner_utilities.cpp). All functions broadcast over
leading dimensions, so one call evaluates every (cell × polygon-edge) pair
at once, on whatever device their inputs lie. Sums over the two
coordinates are written out (x0·y0 + x1·y1), in ``tpunav``'s order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ClosePoint(NamedTuple):
    t: torch.Tensor        # line parameter (unclamped)
    sign_d: torch.Tensor   # signed distance (positive = left of p1→p2)
    point: torch.Tensor    # (..., 2) closest point on the infinite line
    on_seg: torch.Tensor   # bool: 0 <= t <= 1


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _norm(v):
    return torch.sqrt(_dot(v, v))


def min_dist_segment_point(p1, p2, p3):
    """Distance from point(s) p3 to SEGMENT p1→p2 (clamped at endpoints)."""
    d = p2 - p1
    denom = torch.clamp(_dot(d, d), min=1e-12)
    u = torch.clamp(_dot(p3 - p1, d) / denom, 0.0, 1.0)
    closest = p1 + u[..., None] * d
    return _norm(p3 - closest)


def signed_min_dist(p1, p2, p3) -> ClosePoint:
    """Signed perpendicular distance of p3 from the line p1→p2, with the
    leftward normal convention: positive sign = p3 left of the edge — for a
    CCW polygon, inside."""
    v = p2 - p1
    n = torch.stack([-v[..., 1], v[..., 0]], dim=-1)
    n = n / torch.clamp(_norm(n), min=1e-12)[..., None]
    d = p3 - p1
    denom = torch.clamp(_dot(v, v), min=1e-12)
    t = _dot(d, v) / denom
    sign_d = _dot(d, n)
    point = p1 + t[..., None] * v
    on_seg = (t >= -1e-12) & (t <= 1.0 + 1e-12)
    return ClosePoint(t=t, sign_d=sign_d, point=point, on_seg=on_seg)


def polygon_edges(poly, n_vertices):
    """Edges of a padded polygon (V, 2) with ``n_vertices`` real rows:
    (V, 2) start points, (V, 2) end points and a (V,) validity mask. The
    closing edge wraps last→first."""
    idx = torch.arange(poly.shape[-2], device=poly.device)
    nxt = torch.where(idx + 1 >= n_vertices, torch.zeros_like(idx), idx + 1)
    return poly, poly[..., nxt, :], idx < n_vertices


def point_in_polygon(poly, n_vertices, p):
    """True if p is inside (or on the border of) the CCW polygon: every
    edge's signed distance >= 0."""
    a, b, valid = polygon_edges(poly, n_vertices)
    cp = signed_min_dist(a, b, p[None, :])
    return torch.all((cp.sign_d >= -1e-12) | ~valid)


def dist_to_polygon(poly, n_vertices, p):
    """Min distance from p to the polygon boundary (segments, endpoint-
    clamped)."""
    a, b, valid = polygon_edges(poly, n_vertices)
    d = min_dist_segment_point(a, b, p[None, :])
    return torch.amin(torch.where(valid, d, torch.inf))


def segments_intersect(a0, a1, b0, b1):
    """Proper/improper segment intersection test by orientation signs.
    Broadcasts over leading dimensions."""
    def cross(o, p, q):
        return ((p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1]) -
                (p[..., 1] - o[..., 1]) * (q[..., 0] - o[..., 0]))

    d1 = cross(b0, b1, a0)
    d2 = cross(b0, b1, a1)
    d3 = cross(a0, a1, b0)
    d4 = cross(a0, a1, b1)
    proper = ((d1 * d2) < 0.0) & ((d3 * d4) < 0.0)

    def on(o, p, q, d):
        within = ((torch.minimum(o[..., 0], p[..., 0]) - 1e-12 <= q[..., 0])
                  & (q[..., 0] <= torch.maximum(o[..., 0], p[..., 0]) + 1e-12)
                  & (torch.minimum(o[..., 1], p[..., 1]) - 1e-12 <= q[..., 1])
                  & (q[..., 1] <= torch.maximum(o[..., 1], p[..., 1]) + 1e-12))
        return (torch.abs(d) < 1e-12) & within

    touch = on(b0, b1, a0, d1) | on(b0, b1, a1, d2) | \
        on(a0, a1, b0, d3) | on(a0, a1, b1, d4)
    return proper | touch
