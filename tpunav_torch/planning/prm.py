"""Probabilistic roadmap + Theta* any-angle planner.

Port of ``tpunav/planning/prm.py`` (a re-design of ``planner::RoadMap`` and
``planner::PRMPlanner``, planner/src/planner/road_map.cpp,
prm_planner.cpp). As in ``tpunav``, the geometry (free-space rejection,
edge-vs-polygon intersection and clearance) is batched numpy on the host
over all candidates at once, and the A*/Theta* search is a sequential
priority-queue loop on the host, like the reference's sorted-vector open
list (prm_planner.cpp:29-58). Only the candidate draw differs: a
``torch.Generator`` seeded with ``seed`` draws float64 uniforms on the
CPU, so the nodes differ from ``tpunav``'s for the same seed;
``interop.roadmap_from_numpy`` builds a roadmap over given nodes.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import torch

from .world import ObstacleMap


def _all_edges(obs: ObstacleMap):
    """Flatten every polygon edge into (E, 2, 2) arrays (padded edges are
    zero-length at the first vertex and never intersect anything new)."""
    a_list, b_list = [], []
    for poly, n in zip(obs.polygons, obs.n_vertices):
        for i in range(int(n)):
            a_list.append(poly[i])
            b_list.append(poly[(i + 1) % int(n)])
    return np.asarray(a_list), np.asarray(b_list)


# Host-side NumPy mirrors of planning/utilities.py (same formulas, same
# tolerances). The graph search is control-flow heavy, so its geometry
# stays on the host: a device round-trip per expansion would cost more
# than the arithmetic.

def _np_min_dist_segment_point(p1, p2, p3):
    d = p2 - p1
    denom = np.maximum(np.sum(d * d, axis=-1), 1e-12)
    u = np.clip(np.sum((p3 - p1) * d, axis=-1) / denom, 0.0, 1.0)
    closest = p1 + u[..., None] * d
    return np.linalg.norm(p3 - closest, axis=-1)


def _np_segments_intersect(a0, a1, b0, b1):
    def cross(o, p, q):
        return ((p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1]) -
                (p[..., 1] - o[..., 1]) * (q[..., 0] - o[..., 0]))

    d1 = cross(b0, b1, a0)
    d2 = cross(b0, b1, a1)
    d3 = cross(a0, a1, b0)
    d4 = cross(a0, a1, b1)
    proper = ((d1 * d2) < 0.0) & ((d3 * d4) < 0.0)

    def on(o, p, q, d):
        within = ((np.minimum(o[..., 0], p[..., 0]) - 1e-12 <= q[..., 0])
                  & (q[..., 0] <= np.maximum(o[..., 0], p[..., 0]) + 1e-12)
                  & (np.minimum(o[..., 1], p[..., 1]) - 1e-12 <= q[..., 1])
                  & (q[..., 1] <= np.maximum(o[..., 1], p[..., 1]) + 1e-12))
        return (np.abs(d) < 1e-12) & within

    touch = on(b0, b1, a0, d1) | on(b0, b1, a1, d2) | \
        on(a0, a1, b0, d3) | on(a0, a1, b1, d4)
    return proper | touch


class RoadMap:
    """PRM construction (ref: RoadMap::constructRoadMap road_map.cpp:
    189-216): rejection-sample n free nodes, connect k nearest neighbors
    with collision-checked straight edges."""

    def __init__(self, obs: ObstacleMap, n_nodes: int = 200,
                 k_neighbors: int = 10, clearance: float = 0.15,
                 seed: int = 0):
        self._setup(obs, k_neighbors, clearance)
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(seed)
        self._build(self._sample_free(n_nodes))

    def _setup(self, obs: ObstacleMap, k_neighbors: int, clearance: float):
        self.obs = obs
        self.k = k_neighbors
        self.clearance = clearance
        (self.xmin, self.xmax), (self.ymin, self.ymax) = obs.bounds
        self._edge_a, self._edge_b = _all_edges(obs)

        # Padded per-polygon edge arrays for the vectorized inside test:
        # (P, V) edge starts/ends + validity.
        polys = np.asarray(obs.polygons, np.float64)      # (P, V, 2)
        nv = np.asarray(obs.n_vertices, np.int64)         # (P,)
        vmax = polys.shape[1]
        idx = np.arange(vmax)
        nxt = np.where(idx[None, :] + 1 >= nv[:, None], 0,
                       idx[None, :] + 1)                  # (P, V)
        self._poly_a = polys                              # (P, V, 2)
        self._poly_b = np.take_along_axis(
            polys, nxt[..., None].repeat(2, axis=-1), axis=1)
        self._poly_valid = idx[None, :] < nv[:, None]     # (P, V)

    def _build(self, nodes):
        """Take ``nodes`` (n, 2) as the roadmap's and connect them."""
        self.nodes = np.asarray(nodes, np.float64)
        self.n_nodes = len(self.nodes)
        self.adjacency: List[List[int]] = [[] for _ in range(self.n_nodes)]
        self._connect()

    # ---------------------------------------------------- geometry ----

    def _point_free(self, pts):
        """(N,) mask: not inside any polygon and at least ``clearance``
        from every boundary (ref: free-space predicate road_map.cpp:
        378-462 + the bounding-radius check). Fully vectorized over
        (points x polygons x edges) — no per-polygon Python loop."""
        pts = np.asarray(pts, np.float64)
        d = _np_min_dist_segment_point(self._edge_a[None],
                                       self._edge_b[None],
                                       pts[:, None, :])
        far = np.min(d, axis=1) > self.clearance

        # Signed distance of every point to every polygon edge (leftward
        # normal = inside for CCW input, same convention as
        # utilities.signed_min_dist): (N, P, V).
        a, b = self._poly_a, self._poly_b
        v = b - a                                         # (P, V, 2)
        nrm = np.stack([-v[..., 1], v[..., 0]], axis=-1)
        nrm = nrm / np.maximum(
            np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        rel = pts[:, None, None, :] - a[None]             # (N, P, V, 2)
        sign_d = np.sum(rel * nrm[None], axis=-1)         # (N, P, V)
        inside_each = (sign_d >= -1e-12) | ~self._poly_valid[None]
        inside_any = np.any(np.all(inside_each, axis=2), axis=1)

        wall_ok = ((pts[:, 0] > self.xmin + self.clearance) &
                   (pts[:, 0] < self.xmax - self.clearance) &
                   (pts[:, 1] > self.ymin + self.clearance) &
                   (pts[:, 1] < self.ymax - self.clearance))
        return far & ~inside_any & wall_ok

    def edge_free(self, a, b):
        """Collision-free straight edge: no polygon-edge intersection and
        clearance along the segment (ref: lnSegIntersectPolygon +
        lnSegClose2Polygon road_map.cpp:16-119, 465-524)."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        free = self._edges_free(a[None], b[None])
        return bool(free[0])

    def _edges_free(self, a, b):
        """Vectorized edge feasibility for (N, 2) segment endpoints."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        hit = _np_segments_intersect(a[:, None, :], b[:, None, :],
                                     self._edge_a[None],
                                     self._edge_b[None])       # (N, E)
        any_hit = np.any(hit, axis=1)
        # Clearance: polygon vertices must stay > clearance from the edge.
        d = _np_min_dist_segment_point(a[:, None, :], b[:, None, :],
                                       self._edge_a[None])     # (N, E)
        too_close = np.min(d, axis=1) <= self.clearance
        return ~(any_hit | too_close)

    # -------------------------------------------------- construction ----

    def _sample_free(self, n):
        """Rejection sampling via batched oversampling
        (ref: road_map.cpp:189-198's one-at-a-time loop, vectorized)."""
        lo = np.asarray([self.xmin, self.ymin], np.float64)
        hi = np.asarray([self.xmax, self.ymax], np.float64)
        nodes = []
        while len(nodes) < n:
            u = torch.rand((4 * n, 2), generator=self._gen,
                           dtype=torch.float64).numpy()
            cand = lo + u * (hi - lo)
            ok = self._point_free(cand)
            nodes.extend(cand[ok].tolist())
        return np.asarray(nodes[:n])

    def _connect(self):
        """k-nearest-neighbor edges, collision-checked in one batch
        (ref: nearestNeighbors road_map.cpp:296-332)."""
        d = np.linalg.norm(
            self.nodes[:, None, :] - self.nodes[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        nn = np.argsort(d, axis=1)[:, :self.k]
        pairs = [(i, j) for i in range(self.n_nodes) for j in nn[i]
                 if i < j]
        if not pairs:
            return
        a = self.nodes[[p[0] for p in pairs]]
        b = self.nodes[[p[1] for p in pairs]]
        free = self._edges_free(a, b)
        for (i, j), ok in zip(pairs, free):
            if ok:
                self.adjacency[i].append(int(j))
                self.adjacency[int(j)].append(i)

    def add_node(self, p) -> Optional[int]:
        """Insert start/goal configuration, connected to its nearest
        visible neighbors (ref: addStartGoalConfig road_map.cpp:241-290)."""
        p = np.asarray(p, np.float64)
        if not self._point_free(p[None])[0]:
            return None
        idx = len(self.nodes)
        d = np.linalg.norm(self.nodes - p, axis=-1)
        order = np.argsort(d)[:max(self.k, 20)]
        a = np.broadcast_to(p, (len(order), 2))
        free = self._edges_free(a, self.nodes[order])
        nbrs = [int(j) for j, ok in zip(order, free) if ok]
        if not nbrs:
            return None
        self.nodes = np.vstack([self.nodes, p[None]])
        self.adjacency.append(nbrs)
        for j in nbrs:
            self.adjacency[j].append(idx)
        return idx


def theta_star(rm: RoadMap, start_idx: int, goal_idx: int):
    """Any-angle Theta* over the roadmap (ref: PRMPlanner
    prm_planner.cpp:29-199): A* with the line-of-sight shortcut — when the
    expanded node's parent sees the successor, connect the successor
    straight to the parent (updateNode :110-143). Euclidean heuristic.

    Returns the path as an (M, 2) array of node positions, or None.
    """
    n = len(rm.nodes)
    g = np.full(n, np.inf)
    parent = np.full(n, -1, np.int64)
    g[start_idx] = 0.0
    h = np.linalg.norm(rm.nodes - rm.nodes[goal_idx], axis=-1)
    open_heap = [(h[start_idx], start_idx)]
    closed = np.zeros(n, bool)

    def dist(i, j):
        return float(np.linalg.norm(rm.nodes[i] - rm.nodes[j]))

    # Grandparent line-of-sight results, keyed (parent, node). All of an
    # expansion's neighbor queries go through ONE _edges_free batch, not
    # one edge_free() call per neighbor.
    los_cache = {}

    while open_heap:
        _, s = heapq.heappop(open_heap)
        if closed[s]:
            continue
        closed[s] = True
        if s == goal_idx:
            break
        nbrs = [s2 for s2 in rm.adjacency[s] if not closed[s2]]
        p = parent[s]
        if p >= 0 and nbrs:
            unknown = [s2 for s2 in nbrs if (p, s2) not in los_cache]
            if unknown:
                free = rm._edges_free(
                    np.broadcast_to(rm.nodes[p], (len(unknown), 2)),
                    rm.nodes[unknown])
                for s2, ok in zip(unknown, free):
                    los_cache[(p, s2)] = bool(ok)
        for s2 in nbrs:
            # Theta* path-2 shortcut: grandparent line of sight.
            if p >= 0 and los_cache[(p, s2)]:
                cand_g = g[p] + dist(p, s2)
                cand_parent = p
            else:
                cand_g = g[s] + dist(s, s2)
                cand_parent = s
            if cand_g < g[s2]:
                g[s2] = cand_g
                parent[s2] = cand_parent
                heapq.heappush(open_heap, (cand_g + h[s2], s2))

    if not closed[goal_idx] and parent[goal_idx] < 0:
        return None
    path = [goal_idx]
    while path[-1] != start_idx:
        nxt = parent[path[-1]]
        if nxt < 0:
            return None
        path.append(int(nxt))
    return rm.nodes[path[::-1]]
