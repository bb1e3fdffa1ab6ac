"""End-to-end: EKF SLAM closing the MPPI control loop.

Counterpart of ``examples/slam_mppi_closed_loop_demo.py``: the reference's
full stack — ``roslaunch nuslam slam.launch`` + ``mppi_waypoints`` — where
the controller consumes the filter's pose, odometry is biased (the
failure SLAM exists to fix), and landmark frames arrive at a fraction of
the control rate. Two configurations from BASELINE.json:

  3. known data association, the 12-cylinder block world
  4. unknown data association (Mahalanobis gating), 50 random landmarks

Reports course completion, the EKF's and dead reckoning's final errors,
and control ticks/s (the whole loop: solve, plant, filter). On the card
the solve is kernel K1, once per tick.

    python -m examples_torch.slam_mppi_closed_loop_demo [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from examples_torch import device_parser, synchronize
from tpunav_torch.control.mppi import MPPIConfig
from tpunav_torch.control.slam_loop import (SlamLoopConfig, run_slam_loop,
                                            slam_loop_init)
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import EKFConfig
from tpunav_torch.models.cart import CartParams
from tpunav_torch.runtime.config import load_landmarks

MODEL = CartParams(0.033, 0.160)
# In-world square course threading the block world's cylinders.
WAYPOINTS = [[0.5, 0.0, 0.0], [0.4, 0.5, 1.57], [-0.3, 0.45, 3.0],
             [-0.5, -0.2, -1.8], [0.2, -0.5, -0.4]]
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def block_world():
    """The 12 cylinders of configs/block_world_landmarks.yaml, (12, 2)."""
    centers, _ids = load_landmarks(os.path.join(CONFIGS,
                                                "block_world_landmarks.yaml"))
    return np.asarray(centers, np.float32)


def random_landmarks(n=50, seed=7):
    """Config 4's ``n`` landmarks uniform in [-0.9, 0.9)², from a CPU
    generator seeded ``seed``; (n, 2) float32."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 2), generator=gen) * 1.8 - 0.9).numpy()


def configs(known_da: bool, num_slots: int, use_fused: bool = True,
            rollouts: int = 1024):
    """(mppi_cfg, ekf_cfg, loop_cfg) of the demo's course."""
    mppi = MPPIConfig(horizon=0.4, dt=0.05, rollouts=rollouts, ul_var=4.0,
                      ur_var=4.0)
    ekf = EKFConfig(num_landmarks=num_slots, dmin=5e1, dmax=1e4,
                    spd_repair=False, motion_noise=(1e-6, 1e-6, 1e-6),
                    measurement_noise=(1e-6, 1e-6))
    loop = SlamLoopConfig(goal_thresh=0.12, known_da=known_da,
                          sensor_every=6, visibility=1.2,
                          use_fused=use_fused)
    return mppi, ekf, loop


def run(name, landmarks, known_da: bool, num_slots: int, use_fused=None,
        rollouts=1024, max_ticks=6000, seed=1, verbose=True,
        device=DEFAULT_DEVICE):
    """The course from seed 1 until done or ``max_ticks``. ``use_fused``
    defaults to K1 on the card and the plain solver on the CPU. Returns a
    dict (done, ticks, visits, ekf_err_m, odom_err_m, landmarks, wall_s,
    ticks_per_s, state)."""
    device = resolve(device)
    if use_fused is None:
        use_fused = device.type == "cuda"
    mppi, ekf, loop = configs(known_da, num_slots, use_fused, rollouts)
    st = slam_loop_init(mppi, ekf, seed=seed, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    st = run_slam_loop(mppi, ekf, loop, MODEL, WAYPOINTS, landmarks, st,
                       max_ticks=max_ticks)
    synchronize(device)
    wall = time.perf_counter() - t0
    est, tru, odo = (st.ekf.state[:3].cpu(), st.true_pose.cpu(),
                     st.odom.cpu())
    ekf_err = float(torch.hypot(est[1] - tru[0], est[2] - tru[1]))
    odo_err = float(torch.hypot(odo[1] - tru[0], odo[2] - tru[1]))
    ticks = int(st.ticks)
    out = {"done": bool(st.done), "ticks": ticks, "visits": int(st.visits),
           "ekf_err_m": ekf_err, "odom_err_m": odo_err,
           "landmarks": int(st.ekf.count), "wall_s": wall,
           "ticks_per_s": ticks / wall, "state": st}
    if verbose:
        print(f"{name}: done={out['done']} visits={out['visits']}/"
              f"{len(WAYPOINTS)} ticks={ticks} "
              f"ekf_err={ekf_err * 100:.2f}cm odom_err={odo_err * 100:.2f}cm "
              f"landmarks={out['landmarks']} "
              f"({out['ticks_per_s']:.0f} closed-loop ticks/s)", flush=True)
    return out


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    for name, lms, known, slots in [
            ("config3 known-DA 12 cylinders ", block_world(), True, 12),
            ("config4 unknownDA 50 landmarks", random_landmarks(), False,
             60)]:
        out = run(name, lms, known, slots, device=args.device)
        assert out["done"], "course incomplete"
        assert out["ekf_err_m"] < out["odom_err_m"], \
            "filter worse than dead reckoning"


if __name__ == "__main__":
    main()
