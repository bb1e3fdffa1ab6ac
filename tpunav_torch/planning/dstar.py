"""D* Lite incremental replanning on a grid with simulated exploration.

A copy of ``tpunav/planning/dstar.py`` (numpy only, a host search), over
the port's ``grid_map``. Re-design of ``planner::DStarLight``
(ref: planner/include/planner/dstar_light.hpp:91-185,
planner/src/planner/dstar_light.cpp). Like the reference, the planner
holds TWO grids: ``truth`` (the fully labeled planning grid, the C++
``ref_grid``) and an internal belief initialized all-free
(dstar_light.cpp:19-29). ``traverse()`` alternates moving to the min-cost
neighbor, revealing the truth inside a visibility box
(simulateGridUpdate :307-364), updating touched cells, and replanning —
the reference's pathTraversal loop (:97-145).

The priority-queue search is an inherently sequential host loop (the
reference re-sorts a vector per pop, :40-94); we keep a lazy heap with
the same (k1, k2) keys k1 = min(g, rhs) + h, k2 = min(g, rhs)
(grid_map.hpp calculateKeys) plus the standard D* Lite km offset so keys
stay valid as the robot moves.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

from .grid_map import FREE, PlanningGrid

BIG_COST = 1000.0  # cost into obstacle/inflated cells (ref: edgeCost :444-461)

_NBRS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


class DStarLite:
    def __init__(self, grid: PlanningGrid, start: Tuple[int, int],
                 goal: Tuple[int, int], vis_radius: int = 3):
        self.truth = grid.labels                  # (H, W) ground truth
        self.h_, self.w_ = self.truth.shape
        self.belief = np.full_like(self.truth, FREE)   # assumed free
        self.start = tuple(start)
        self.goal = tuple(goal)
        self.pos = tuple(start)
        self.vis = vis_radius
        self.km = 0.0
        self.last = tuple(start)

        self.g = np.full(self.truth.shape, np.inf)
        self.rhs = np.full(self.truth.shape, np.inf)
        self.rhs[self.goal] = 0.0
        self.open: List = []
        self.open_set = {}
        self._push(self.goal)
        self.visited: List[Tuple[int, int]] = [self.pos]

    # ------------------------------------------------------ helpers ----

    def _h(self, s):
        return math.hypot(s[0] - self.pos[0], s[1] - self.pos[1])

    def _key(self, s):
        m = min(self.g[s], self.rhs[s])
        return (m + self._h(s) + self.km, m)

    def _push(self, s):
        k = self._key(s)
        self.open_set[s] = k
        heapq.heappush(self.open, (k, s))

    def _cost(self, a, b):
        """(ref: edgeCost dstar_light.cpp:444-461 — euclidean, or 1000
        into non-free cells of the BELIEF grid.)"""
        if self.belief[b] != FREE or self.belief[a] != FREE:
            return BIG_COST
        return math.hypot(a[0] - b[0], a[1] - b[1])

    def _neighbors(self, s):
        for dy, dx in _NBRS:
            t = (s[0] + dy, s[1] + dx)
            if 0 <= t[0] < self.h_ and 0 <= t[1] < self.w_:
                yield t

    # ------------------------------------------------------- search ----

    def _update(self, s):
        """(ref: updateCell dstar_light.cpp:239-269.)"""
        if s != self.goal:
            self.rhs[s] = min(
                (self._cost(s, t) + self.g[t] for t in self._neighbors(s)),
                default=np.inf)
        self.open_set.pop(s, None)
        if self.g[s] != self.rhs[s]:
            self._push(s)

    def compute_shortest_path(self, max_pops: int = 500_000):
        """(ref: planPath dstar_light.cpp:40-94.)"""
        pops = 0
        while self.open and pops < max_pops:
            k_old, s = self.open[0]
            if self.open_set.get(s) != k_old:
                heapq.heappop(self.open)           # stale entry
                continue
            k_start = self._key(self.pos)
            if not (k_old < k_start or
                    self.rhs[self.pos] != self.g[self.pos]):
                break
            heapq.heappop(self.open)
            self.open_set.pop(s, None)
            pops += 1
            k_new = self._key(s)
            if k_old < k_new:
                self._push(s)
            elif self.g[s] > self.rhs[s]:          # over-consistent
                self.g[s] = self.rhs[s]
                for t in self._neighbors(s):
                    self._update(t)
            else:                                  # under-consistent
                self.g[s] = np.inf
                self._update(s)
                for t in self._neighbors(s):
                    self._update(t)

    # ---------------------------------------------------- traversal ----

    def _reveal(self):
        """Reveal the truth grid inside the visibility box; returns the
        cells whose label changed (ref: simulateGridUpdate :307-364)."""
        y0 = max(0, self.pos[0] - self.vis)
        y1 = min(self.h_, self.pos[0] + self.vis + 1)
        x0 = max(0, self.pos[1] - self.vis)
        x1 = min(self.w_, self.pos[1] + self.vis + 1)
        box_truth = self.truth[y0:y1, x0:x1]
        box_belief = self.belief[y0:y1, x0:x1]
        changed = np.argwhere(box_truth != box_belief)
        cells = [(int(y) + y0, int(x) + x0) for y, x in changed]
        self.belief[y0:y1, x0:x1] = box_truth
        return cells

    def _min_neighbor(self):
        """(ref: minNeighbor dstar_light.cpp:396-428.)"""
        best, best_c = None, np.inf
        for t in self._neighbors(self.pos):
            c = self._cost(self.pos, t) + self.g[t]
            if c < best_c:
                best, best_c = t, c
        return best

    def _apply_changes(self, cells):
        """Edge-cost bookkeeping for belief cells that changed: km offset
        + rhs updates of the cells and their neighbors
        (ref: pathTraversal's changed-cell loop dstar_light.cpp:118-141)."""
        if not cells:
            return
        self.km += self._h(self.last)
        self.last = self.pos
        for c in cells:
            self._update(c)
            for t in self._neighbors(c):
                self._update(t)

    def observe(self, labels: np.ndarray):
        """Online map update: replace the belief wherever ``labels``
        disagrees (labels: full (H, W) planning labels, e.g. derived from
        a SLAM occupancy grid) and replan incrementally. This is the
        live-perception analog of the reference's simulated truth reveal
        (simulateGridUpdate :307-364) — the map source is a real filter
        instead of the built-in simulator."""
        changed = np.argwhere(labels != self.belief)
        cells = [tuple(map(int, c)) for c in changed]
        self.belief[:] = labels
        self._apply_changes(cells)
        self.compute_shortest_path()

    def advance(self):
        """One execution step toward the goal on the current belief;
        returns the new (iy, ix) or None when stuck/unreachable
        (ref: minNeighbor move, dstar_light.cpp:97-145)."""
        if self.pos == self.goal:
            return self.pos
        if not np.isfinite(self.g[self.pos]):
            return None
        nxt = self._min_neighbor()
        if nxt is None:
            return None
        self.pos = nxt
        self.visited.append(nxt)
        return nxt

    def path_to_goal(self, max_len: int = 10_000):
        """Greedy min-cost descent from the current position to the goal
        on the current belief (for lookahead waypoint extraction); returns
        an (M, 2) int array starting at ``pos``."""
        path = [self.pos]
        saved_pos = self.pos
        seen = {self.pos}
        while self.pos != self.goal and len(path) < max_len:
            nxt = self._min_neighbor()
            if nxt is None or nxt in seen or not np.isfinite(self.g[nxt]):
                break
            self.pos = nxt
            seen.add(nxt)
            path.append(nxt)
        self.pos = saved_pos
        return np.asarray(path)

    def traverse(self, max_steps: int = 10_000) -> Optional[np.ndarray]:
        """Plan + execute with incremental replanning
        (ref: pathTraversal dstar_light.cpp:97-145). Returns the visited
        path as (M, 2) [iy, ix], or None if no path exists."""
        self._reveal()
        self.compute_shortest_path()
        for _ in range(max_steps):
            if self.pos == self.goal:
                return np.asarray(self.visited)
            nxt = self.advance()
            if nxt is None:
                return None
            self._apply_changes(self._reveal())
            self.compute_shortest_path()
        return None


def dstar_from_labels(labels: np.ndarray, start, goal, vis_radius: int = 3
                      ) -> DStarLite:
    """Construct a planner directly from a (H, W) label array (e.g. an
    all-free prior for online SLAM-fed planning) without a PlanningGrid."""
    class _G:
        pass

    g = _G()
    g.labels = np.asarray(labels).copy()
    return DStarLite(g, start, goal, vis_radius)
