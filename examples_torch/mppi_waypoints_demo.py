"""End-to-end: MPPI waypoint following with a simulated diff-drive plant.

Counterpart of ``examples/mppi_waypoints_demo.py``, the port's equivalent
of ``roslaunch nuturtle_robot mppi_waypoints.launch`` (ref:
nuturtle_robot/src/mppi_waypoints_node.cpp): controller, plant, odometer
and waypoint manager in one course loop (``tpunav_torch.control.
waypoint_loop``), read by the host once per chunk of 240 ticks. The
configurations come from the reference-schema files in ``configs/``
(mppi_params.yaml at a 0.5 s horizon, the real_waypoints.yaml pentagon).
Two runs: the plain solver at K=1,024, then the flagship, the fused solve
(kernel K1 on the card) at K=4,096.

    python -m examples_torch.mppi_waypoints_demo [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from examples_torch import device_parser, draw, out_path, synchronize
from tpunav_torch.control.waypoint_loop import (CourseConfig, course_init,
                                                run_course_chunked)
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.models.cart import CartParams
from tpunav_torch.runtime.config import (load_mppi_config, load_robot_config,
                                         load_waypoints)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
CHUNK = 240


def run(use_fused: bool, rollouts: int, max_ticks: int = 20_000,
        verbose: bool = True, device=DEFAULT_DEVICE):
    """One course to done or ``max_ticks``; returns a dict (done, ticks,
    visits, final pose, wall and steady seconds, steady solves/s, and the
    per-tick d2g and waypoint-index stream). The course replays a graph
    per chunk: its first chunk runs eagerly (the warm-up) and its second
    is captured, so the steady rate is that of the chunks after them (of
    those after the first where the course has only two)."""
    device = resolve(device)
    cfg = load_mppi_config(os.path.join(CONFIGS, "mppi_params.yaml"),
                           horizon=0.5, rollouts=rollouts)
    robot = load_robot_config(os.path.join(CONFIGS, "diff_params.yaml"))
    cart = CartParams(robot.wheel_radius, robot.wheel_base)
    course = CourseConfig(goal_thresh=0.1, tick_dt=1.0 / 60.0,
                          max_ticks=max_ticks, use_fused=use_fused)
    waypoints = torch.from_numpy(np.asarray(load_waypoints(
        os.path.join(CONFIGS, "real_waypoints.yaml")), np.float32)).to(device)
    name = "fused" if use_fused else "plain"
    if verbose:
        print(f"--- solver={name} K={rollouts} on {device} ---")
    st = course_init(cfg, [0.0, 0.0, 0.0], seed=0, device=device)

    last = {"visits": 0}
    ends = []          # the host's clock at each chunk's end
    stream = []        # per-tick telemetry chunks (the PoseError stream)
    synchronize(device)
    t0 = time.perf_counter()

    def report(st, tel):
        ends.append(time.perf_counter())
        stream.append({k: v.cpu().numpy() for k, v in tel.items()})
        v = int(st.visits)
        if v != last["visits"] and verbose:
            pose = st.pose.cpu().numpy()
            print(f"  visited {v}/{len(waypoints)} waypoints "
                  f"(tick {int(st.ticks)}, pose [{pose[0]:.3f} "
                  f"{pose[1]:.3f} {pose[2]:.3f}])")
        last["visits"] = v

    st = run_course_chunked(cfg, course, cart, waypoints, st, chunk=CHUNK,
                            on_chunk=report)
    synchronize(device)
    t_end = time.perf_counter()
    ticks = int(st.ticks)
    skip = min(2, len(ends) - 1)
    steady_ticks = max(ticks - skip * CHUNK, 1)
    steady = max(t_end - (ends[skip - 1] if skip else t0), 1e-9)
    out = {"done": bool(st.done), "ticks": ticks, "visits": int(st.visits),
           "pose": st.pose.cpu().numpy(), "wall_s": t_end - t0,
           "steady_s": steady, "solves_per_s": steady_ticks / steady,
           "rollouts": cfg.rollouts, "name": name,
           "d2g": np.concatenate([c["d2g"] for c in stream])[:ticks],
           "wpt_idx": np.concatenate([c["wpt_idx"] for c in stream])[:ticks]}
    if verbose:
        print(f"course {'done' if out['done'] else 'INCOMPLETE'}: {ticks} "
              f"ticks ({ticks / 60.0:.1f} s of 60 Hz control), "
              f"K={cfg.rollouts}")
        print(f"  total {out['wall_s']:.1f} s wall; steady state "
              f"{out['solves_per_s']:.0f} solves/s = "
              f"{out['solves_per_s'] / 60.0:.1f}x real time")
    return out


def plot(out):
    """The per-tick stream → a time-series plot (the reference's rqt_plot
    of PoseError, tsim/launch/trect.launch:18-21)."""
    from tpunav_torch.viz import plot_series

    path = plot_series(
        {"distance to active waypoint [m]": out["d2g"],
         "active waypoint index": out["wpt_idx"]},
        [("m", ["distance to active waypoint [m]"]),
         ("idx", ["active waypoint index"])],
        out_path(f"mppi_waypoints_{out['name']}_timeseries.png"),
        title=f"MPPI waypoint course ({out['name']}, K={out['rollouts']})")
    print(f"  wrote {path}")


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    for use_fused, k in ((False, 1024), (True, 4096)):
        out = run(use_fused, k, device=args.device)
        draw(plot, out)


if __name__ == "__main__":
    main()
