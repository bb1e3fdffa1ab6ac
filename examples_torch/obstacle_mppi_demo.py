"""BASELINE config 2 on the fused path: obstacle-aware MPPI at K=4,096,
N=50, with the obstacle cost evaluated inside the solve (kernel K1's
obstacle mode).

Counterpart of ``examples/obstacle_mppi_demo.py``. As in the reference
stack, a global planner feeds the local controller: Theta* on a PRM routes
round a wall (ref: planner/src/prm_planner.cpp Theta* shortcut :110-143),
and the MPPI rollouts price clearance against the same obstacle segments
in the kernel — no grid distance field, one kernel per solve.

    python -m examples_torch.obstacle_mppi_demo [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from examples_torch import device_parser, synchronize
from tpunav_torch.control.mppi import MPPIConfig
from tpunav_torch.control.obstacle_cost import (SegmentCostParams,
                                                segments_from_polygons)
from tpunav_torch.control.waypoint_loop import (CourseConfig, course_init,
                                                run_course_chunked)
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.models.cart import CartParams
from tpunav_torch.planning import RoadMap, load_obstacle_map, theta_star

MODEL = CartParams(0.033, 0.160)
WALL = [[[0.95, 0.7], [1.05, 0.7], [1.05, 1.3], [0.95, 1.3]]]
START, GOAL = [0.2, 1.0], [1.8, 1.0]
# Sharp field (sigma=0.05): strong inside ~15 cm of the wall, negligible at
# the Theta* route's 0.2 m clearance — otherwise the field gradient
# balances the LQR pull and the course stalls short of waypoints.
OBS_CFG = SegmentCostParams(r_safe=0.1, w_hit=1e7, w_field=2e3, sigma=0.05)


def plan_route():
    """Theta* on an 80-node PRM (seed 2) from START to GOAL round the
    wall; (M, 3) float32 waypoints without the start node."""
    world = load_obstacle_map(WALL, bounds=[[0.0, 2.0], [0.0, 2.0]],
                              resolution=0.05)
    rm = RoadMap(world, n_nodes=80, k_neighbors=10, clearance=0.18, seed=2)
    s_idx, g_idx = rm.add_node(START), rm.add_node(GOAL)
    route = theta_star(rm, s_idx, g_idx)
    assert route is not None, "no route round the wall"
    wpts = np.asarray(route, np.float32)[1:]   # skip the start node
    return np.concatenate([wpts, np.zeros((len(wpts), 1), np.float32)], 1)


def wall_clearance(poses) -> float:
    """Closest approach of (T, ≥2) positions to the wall, 0 inside it."""
    p = np.asarray(poses)
    dx = np.clip(p[:, 0], 0.95, 1.05) - p[:, 0]
    dy = np.clip(p[:, 1], 0.7, 1.3) - p[:, 1]
    d = np.hypot(dx, dy)
    inside = (np.abs(p[:, 0] - 1.0) < 0.05) & (np.abs(p[:, 1] - 1.0) < 0.3)
    d[inside] = 0.0
    return float(d.min())


def run(rollouts=4096, max_ticks=20_000, waypoints=None, verbose=True,
        device=DEFAULT_DEVICE):
    """The course to done or ``max_ticks`` on the fused solve with the
    wall's 4 segments priced in the kernel; returns a dict (done, ticks,
    final pose, min wall clearance, wall seconds, route)."""
    device = resolve(device)
    waypoints = plan_route() if waypoints is None else waypoints
    if verbose:
        print(f"theta* route: "
              f"{[f'({p[0]:.2f},{p[1]:.2f})' for p in waypoints]}")
    segs = segments_from_polygons(WALL, device=device)
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=rollouts)  # N=50 steps
    course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                          max_ticks=max_ticks, use_fused=True)
    st = course_init(cfg, [START[0], START[1], 0.0], seed=0, device=device)
    clear = {"d": np.inf}

    def report(st, tel):
        clear["d"] = min(clear["d"], wall_clearance(tel["pose"].cpu()))

    synchronize(device)
    t0 = time.perf_counter()
    st = run_course_chunked(cfg, course, MODEL,
                            torch.from_numpy(waypoints).to(device), st,
                            chunk=240, obstacles=segs, obs_cfg=OBS_CFG,
                            on_chunk=report)
    synchronize(device)
    out = {"done": bool(st.done), "ticks": int(st.ticks),
           "pose": st.pose.cpu().numpy(),
           "min_clearance_m": min(clear["d"], wall_clearance(
               st.pose.cpu()[None])),
           "wall_s": time.perf_counter() - t0, "route": waypoints,
           "segments": int(segs.shape[0])}
    if verbose:
        print(f"course {'done' if out['done'] else 'INCOMPLETE'} in "
              f"{out['ticks']} ticks ({out['wall_s']:.1f}s wall, "
              f"K={cfg.rollouts}, N={cfg.steps}, in-kernel obstacle cost, "
              f"{out['segments']} segments, on {device})")
        pose = out["pose"]
        print(f"final pose [{pose[0]:.3f} {pose[1]:.3f}], goal {GOAL}; "
              f"min wall clearance {out['min_clearance_m'] * 100:.1f} cm")
    return out


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    out = run(device=args.device)
    assert out["done"], "goal not reached"
    assert out["min_clearance_m"] > 0.05, "trajectory scraped the wall"


if __name__ == "__main__":
    main()
