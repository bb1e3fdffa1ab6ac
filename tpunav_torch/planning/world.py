"""Obstacle-map configuration: padded polygon arrays + the reference world.

A copy of ``tpunav/planning/world.py``, which imports only numpy (the port
imports nothing of ``tpunav``). Mirrors planner/config/map_boundaries.yaml
(loaded in the reference via triple-nested XmlRpc,
grid_planner_node.cpp:104-117); here the same data is a padded (P, V, 2)
array + per-polygon vertex counts so collision tests stay static-shaped.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class ObstacleMap(NamedTuple):
    polygons: np.ndarray    # (P, V, 2) padded vertex array
    n_vertices: np.ndarray  # (P,) real vertex counts
    bounds: np.ndarray      # (2, 2) [[xmin, xmax], [ymin, ymax]]
    resolution: float


def load_obstacle_map(obstacles: Sequence[Sequence[Sequence[float]]],
                      bounds, resolution: float = 0.1,
                      scale: float = 1.0) -> ObstacleMap:
    """Build a padded obstacle map. ``scale`` mirrors the launch-file
    coordinate scaling (planner/launch/plan.launch multiplies the yaml
    world by 0.1)."""
    p = len(obstacles)
    vmax = max(len(poly) for poly in obstacles)
    arr = np.zeros((p, vmax, 2), np.float64)
    counts = np.zeros((p,), np.int32)
    for i, poly in enumerate(obstacles):
        counts[i] = len(poly)
        arr[i, :len(poly)] = np.asarray(poly, np.float64) * scale
        # Pad with the first vertex so degenerate edges sit ON the polygon.
        arr[i, len(poly):] = arr[i, 0]
    b = np.asarray(bounds, np.float64) * scale
    return ObstacleMap(polygons=arr, n_vertices=counts, bounds=b,
                       resolution=resolution * scale)


# The reference world (planner/config/map_boundaries.yaml:1-22), at the
# launch files' 0.1 scale → a 3.4 x 4.8 m world.
_RAW_OBSTACLES = [
    [[12.0, 6.0], [14.5, 3.5], [17.0, 5.5], [17.0, 8.5], [14.0, 8.0]],
    [[24.0, 6.0], [26.0, 3.5], [31.0, 7.5], [24.5, 9.5]],
    [[34.0, 26.0], [10.0, 26.0], [10.0, 12.0], [34.0, 12.0]],
    [[0.0, 26.0], [0.0, 6.0], [4.0, 6.0], [4.0, 26.0]],
    [[4.0, 32.0], [6.0, 30.0], [8.0, 32.0]],
    [[17.0, 32.0], [18.0, 30.0], [19.0, 32.0]],
    [[0.0, 36.0], [0.0, 32.0], [29.0, 32.0], [29.0, 36.0]],
    [[34.0, 36.0], [33.0, 34.0], [34.0, 32.0]],
    [[6.0, 44.0], [2.0, 43.0], [2.0, 39.0], [6.0, 38.0], [8.0, 41.0]],
    [[11.0, 48.0], [17.0, 41.0], [14.0, 48.0]],
    [[30.0, 48.0], [22.0, 40.0], [32.0, 48.0]],
]

REFERENCE_MAP = load_obstacle_map(
    _RAW_OBSTACLES, bounds=[[0.0, 34.0], [0.0, 48.0]], resolution=1.0,
    scale=0.1)
