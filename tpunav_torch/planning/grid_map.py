"""C-space planning grid with obstacle inflation.

Port of ``tpunav/planning/grid_map.py`` (a re-design of
``planner::GridMap``, planner/src/planner/grid_map.cpp). Every cell is
labelled by two predicates, evaluated for all cells × polygons × vertices
in one batched tensor pass on ``device``:

- state 1 (obstacle): the cell center is inside (or on the border of) a
  CCW polygon — every edge's signed distance >= 0;
- state 2 (inflated): within ``bnd_rad`` of any polygon boundary or the
  world walls, where bnd_rad = inflation + resolution/2;
- state 0: free.

The labels come back as a numpy int8 array, as ``tpunav``'s do. ``dtype``
is the arithmetic's: float32 by default, what ``tpunav`` computes without
jax's x64 mode; float64 reproduces ``tpunav`` under x64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from .utilities import min_dist_segment_point, signed_min_dist
from .world import ObstacleMap

FREE = 0
OBSTACLE = 1
INFLATED = 2


class PlanningGrid:
    """Labeled occupancy grid over a polygonal world."""

    def __init__(self, obs_map: ObstacleMap, inflation: float = 0.1,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        self.obs = obs_map
        self.resolution = float(obs_map.resolution)
        (self.xmin, self.xmax), (self.ymin, self.ymax) = obs_map.bounds
        self.bnd_rad = inflation + 0.5 * self.resolution
        # The 1e-9 guard keeps e.g. 4.8/0.1 = 48.000000000000007 from
        # ceiling to 49 cells (the reference computes 48 x 34).
        self.width = int(np.ceil(
            (self.xmax - self.xmin) / self.resolution - 1e-9))
        self.height = int(np.ceil(
            (self.ymax - self.ymin) / self.resolution - 1e-9))
        self.labels = self._label_all(resolve(device), dtype)

    def world_to_grid(self, xy):
        ix = np.clip(((np.asarray(xy)[..., 0] - self.xmin) //
                      self.resolution).astype(int), 0, self.width - 1)
        iy = np.clip(((np.asarray(xy)[..., 1] - self.ymin) //
                      self.resolution).astype(int), 0, self.height - 1)
        return iy, ix

    def grid_to_world(self, iy, ix):
        """Cell center (ref: grid2World grid_map.cpp:160-189)."""
        x = self.xmin + (np.asarray(ix) + 0.5) * self.resolution
        y = self.ymin + (np.asarray(iy) + 0.5) * self.resolution
        return np.stack([x, y], axis=-1)

    def _label_all(self, device, dtype):
        res = self.resolution
        xmin, xmax, ymin, ymax = map(float, (self.xmin, self.xmax,
                                             self.ymin, self.ymax))
        xs = xmin + (torch.arange(self.width, dtype=dtype,
                                  device=device) + 0.5) * res
        ys = ymin + (torch.arange(self.height, dtype=dtype,
                                  device=device) + 0.5) * res
        py, px = torch.meshgrid(ys, xs, indexing="ij")     # (H, W)
        pts = torch.stack([px, py], dim=-1).reshape(-1, 2)  # (C, 2)

        polys = torch.as_tensor(self.obs.polygons, dtype=dtype,
                                device=device)              # (P, V, 2)
        counts = torch.as_tensor(self.obs.n_vertices, dtype=torch.int64,
                                 device=device)             # (P,)
        idx = torch.arange(polys.shape[1], device=device)
        nxt = torch.where(idx + 1 >= counts[:, None], torch.zeros_like(idx),
                          idx + 1)                          # (P, V)
        valid = idx < counts[:, None]                       # (P, V)
        a = polys                                           # (P, V, 2)
        b = torch.gather(polys, 1, nxt[..., None].expand(-1, -1, 2))

        # (C, P, V): every cell against every edge of every polygon.
        p = pts[:, None, None, :]
        cp = signed_min_dist(a[None], b[None], p)
        inside = torch.all((cp.sign_d >= -1e-12) | ~valid, dim=2)
        inside = torch.any(inside, dim=1)                   # (C,)
        d = min_dist_segment_point(a[None], b[None], p)
        near = torch.amin(torch.where(valid, d, torch.inf), dim=(1, 2))

        # World walls (ref: collideWalls grid_map.cpp:403-437).
        wall_d = torch.minimum(
            torch.minimum(pts[:, 0] - xmin, xmax - pts[:, 0]),
            torch.minimum(pts[:, 1] - ymin, ymax - pts[:, 1]))

        labels = torch.where(
            inside, OBSTACLE,
            torch.where((near <= self.bnd_rad) | (wall_d <= self.bnd_rad),
                        INFLATED, FREE))
        return labels.reshape(self.height, self.width).to(
            torch.int8).cpu().numpy()

    def passable(self, iy, ix):
        return self.labels[iy, ix] == FREE

    def occupancy(self):
        """int8 export: 0 free, 100 obstacle, 50 inflated (rviz-style)."""
        out = np.zeros_like(self.labels, np.int8)
        out[self.labels == OBSTACLE] = 100
        out[self.labels == INFLATED] = 50
        return out
