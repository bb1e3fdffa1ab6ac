"""``tpunav``'s EKF course errors on the JAX CPU, for comparison with the
port's (``RESULTS_torch.md``, ``tools/detector_fit_precision.py``) and with
``RESULTS.md``'s rows, which come from a TPU run.

    python3 tools/tpunav_ekf_errors.py [--seeds 0 1 2] [--steps 400]
        [--dense-seeds 0]

Runs ``examples/lidar_ekf_slam_demo.py``'s ``run_many`` (JAX, CPU, float32,
x64 off) for known and unknown data association with the demo's filter
configurations, and ``examples/dense_world_slam_demo.py``'s ``run`` (5,000
ticks, its plain MPPI solver) for each of ``--dense-seeds``; prints one
JSON line: per course the SLAM |xy| error in cm per seed and their mean,
the odometry's, and the landmarks tracked.
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from examples import dense_world_slam_demo as jdw  # noqa: E402
from examples import lidar_ekf_slam_demo as jle  # noqa: E402
from tpunav.estimation.ekf import (EKFConfig,  # noqa: E402
                                   known_correspondence_slam, slam_unknown_da)

CONFIGS = {
    "known": (known_correspondence_slam, True,
              EKFConfig(num_landmarks=12, spd_repair=False,
                        motion_noise=(1e-6, 1e-6, 1e-6),
                        measurement_noise=(1e-5, 1e-5))),
    "unknown": (slam_unknown_da, False,
                EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                          spd_repair=False, motion_noise=(1e-5, 1e-5, 1e-5),
                          measurement_noise=(1e-5, 1e-5))),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--dense-seeds", type=int, nargs="*", default=[0])
    args = ap.parse_args()
    out = {"seeds": args.seeds, "steps": args.steps, "platform": "cpu"}
    for tag, (step, known, cfg) in CONFIGS.items():
        e, eo, counts, _ = jle.run_many(step, cfg, known, args.seeds,
                                        args.steps)
        slam = 100 * np.hypot(np.asarray(e)[:, 1], np.asarray(e)[:, 2])
        odo = 100 * np.hypot(np.asarray(eo)[:, 1], np.asarray(eo)[:, 2])
        out[tag] = {"slam_xy_cm": slam.tolist(),
                    "slam_xy_cm_mean": float(slam.mean()),
                    "odometry_xy_cm_mean": float(odo.mean()),
                    "landmarks_tracked": np.asarray(counts).tolist()}
    if args.dense_seeds:
        runs = [jdw.run(seed) for seed in args.dense_seeds]
        slam = [100 * float(np.hypot(*np.asarray(r[0])[1:])) for r in runs]
        out["dense_world"] = {
            "seeds": args.dense_seeds, "ticks": runs[0][4],
            "slam_xy_cm": slam, "slam_xy_cm_mean": float(np.mean(slam)),
            "odometry_xy_cm_mean": float(np.mean(
                [100 * np.hypot(*np.asarray(r[1])[1:]) for r in runs])),
            "landmarks_tracked": [r[2] for r in runs]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
