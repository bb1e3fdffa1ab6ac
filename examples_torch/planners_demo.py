"""End-to-end: the three global planners on the reference world.

Counterpart of ``examples/planners_demo.py``, the port's equivalent of
``roslaunch planner plan.launch plan_type:={0,1,2}`` (ref: planner/src/
{prm_planner,grid_planner,potential_field_planner}_node.cpp, world
planner/config/map_boundaries.yaml at the launch files' 0.1 scale): PRM +
Theta*, D* Lite with simulated incremental discovery, and potential-field
gradient descent on the same 3.4 × 4.8 m world, each drawn to a PNG in
place of rviz's MarkerArrays. The grid labels and the potential field run
on ``--device``; the graph searches run on the host.

    python -m examples_torch.planners_demo [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from examples_torch import device_parser, draw, out_path
from tpunav_torch import interop, viz
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.planning import (REFERENCE_MAP, DStarLite, PlanningGrid,
                                   PotentialField, PotentialFieldConfig,
                                   RoadMap, theta_star)

START = (0.6, 0.3)
GOAL = (2.0, 4.3)
# Gradient descent has no global view: its goal is one it can reach
# without crossing the big central wall (a corridor along the bottom of
# the world that has no local minimum).
PF_START, PF_GOAL = (0.5, 0.15), (3.2, 0.2)


def run_prm(nodes=None):
    """PRM (200 nodes, seed 42, or the given (n, 2) ``nodes`` through
    ``interop.roadmap_from_numpy``) + Theta* from START to GOAL; returns
    (roadmap, path (M, 2), length m, seconds)."""
    t0 = time.perf_counter()
    if nodes is None:
        rm = RoadMap(REFERENCE_MAP, n_nodes=200, k_neighbors=10,
                     clearance=0.12, seed=42)
    else:
        rm = interop.roadmap_from_numpy(REFERENCE_MAP, nodes, k_neighbors=10,
                                        clearance=0.12)
    s, g = rm.add_node(START), rm.add_node(GOAL)
    path = theta_star(rm, s, g)
    assert path is not None, "PRM found no path"
    path = np.asarray(path)
    length = float(np.sum(np.linalg.norm(np.diff(path, axis=0), axis=1)))
    return rm, path, length, time.perf_counter() - t0


def run_dstar(device=DEFAULT_DEVICE):
    """D* Lite over the labelled grid (0.12 m inflation, labelled on
    ``device``), revealing the world inside a 5-cell box as it drives;
    returns (grid, traversed cells (M, 2) [iy, ix], seconds)."""
    t0 = time.perf_counter()
    grid = PlanningGrid(REFERENCE_MAP, inflation=0.12, device=resolve(device))
    s, g = grid.world_to_grid(START), grid.world_to_grid(GOAL)
    d = DStarLite(grid, tuple(int(v) for v in s), tuple(int(v) for v in g),
                  vis_radius=5)
    traj = d.traverse()
    assert traj is not None, "D* Lite failed to reach the goal"
    return grid, traj, time.perf_counter() - t0


def run_potential_field(device=DEFAULT_DEVICE):
    """Gradient descent from PF_START to PF_GOAL on ``device``; returns
    (path (M, 2), final distance to the goal m, seconds)."""
    t0 = time.perf_counter()
    pf = PotentialField(
        PotentialFieldConfig(w_att=1.2, w_rep=0.02, dthresh=0.4,
                             qthresh=0.25, step=0.02, eps=0.08),
        REFERENCE_MAP, device=resolve(device))
    path = pf.plan(np.asarray(PF_START), np.asarray(PF_GOAL), max_steps=5000)
    assert path is not None and len(path) > 1, "potential field stalled"
    path = torch.stack(path).cpu().numpy()
    return path, float(np.hypot(*(path[-1] - np.asarray(PF_GOAL)))), \
        time.perf_counter() - t0


def world_ax():
    polys = [np.asarray(p[:n]) for p, n in
             zip(REFERENCE_MAP.polygons, REFERENCE_MAP.n_vertices)]
    return viz.draw_world(polys, bounds=[tuple(REFERENCE_MAP.bounds[0]),
                                         tuple(REFERENCE_MAP.bounds[1])])


def plot_prm(rm, path, length):
    ax = world_ax()
    ax.plot(rm.nodes[:, 0], rm.nodes[:, 1], ".", ms=2, color="tab:cyan")
    viz.draw_path(path, ax=ax, color="tab:blue", label="Theta* path")
    viz.save(ax, out_path("prm_theta_star.png"), f"PRM + Theta* "
             f"({length:.2f} m)")


def plot_dstar(grid, traj):
    world = np.asarray([grid.grid_to_world(iy, ix) for iy, ix in traj])
    ax = world_ax()
    viz.draw_path(world, ax=ax, color="tab:orange", label="D* Lite")
    viz.save(ax, out_path("dstar_lite.png"), "D* Lite (incremental "
             "replanning)")


def plot_potential_field(path):
    ax = world_ax()
    viz.draw_path(path, ax=ax, color="tab:green", label="potential field")
    viz.save(ax, out_path("potential_field.png"),
             "Potential-field gradient descent")


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    rm, path, length, dt = run_prm()
    print(f"PRM+Theta*: {len(rm.nodes)} nodes, path {len(path)} vertices, "
          f"length {length:.2f} m, {dt:.2f}s")
    grid, traj, dt = run_dstar(args.device)
    print(f"D* Lite: {len(traj)} cells traversed with incremental "
          f"discovery, {dt:.2f}s")
    pf_path, dist, dt = run_potential_field(args.device)
    print(f"potential field: {len(pf_path)} GD steps, final dist to goal "
          f"{dist:.3f} m, {dt:.2f}s")
    draw(plot_prm, rm, path, length)
    draw(plot_dstar, grid, traj)
    draw(plot_potential_field, pf_path)


if __name__ == "__main__":
    main()
