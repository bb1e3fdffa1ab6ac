"""What the circle detector's float64 fit is worth on the lidar EKF course.

The port fits circles in float64 whatever the scan's dtype
(``tpunav_torch.estimation.landmarks.FIT_DTYPE``); ``tpunav`` fits in
float32. This runs ``examples_torch.lidar_ekf_slam_demo``'s course (400
steps, the 12-cylinder block world, known and unknown data association)
for the given seeds twice: with the fit in float64, as the package runs
it, and with the fit forced to float32. Each run prints one JSON line with
the final SLAM and odometry |xy| errors and the landmarks tracked; the
last line gives, per association and fit, the mean SLAM |xy| error in cm.

    python3 tools/detector_fit_precision.py [--seeds 0 1 2] [--steps 400]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from examples_torch import lidar_ekf_slam_demo as le  # noqa: E402
from tpunav_torch.estimation import landmarks  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    means = {}
    try:
        for fit in (torch.float64, torch.float32):
            landmarks.FIT_DTYPE = fit
            name = str(fit).removeprefix("torch.")
            for tag, (step, known, cfg) in le.CONFIGS.items():
                errs = []
                for seed in args.seeds:
                    ekf_err, odo_err, n_lm, wall, _, _ = le.run(
                        step, cfg, known, args.steps, seed=seed,
                        device=args.device)
                    slam = float(np.hypot(*ekf_err[1:]))
                    errs.append(slam)
                    print(json.dumps({
                        "fit": name, "da": tag, "seed": seed,
                        "steps": args.steps, "slam_xy_error_m": slam,
                        "odometry_xy_error_m": float(np.hypot(*odo_err[1:])),
                        "landmarks_tracked": n_lm}), flush=True)
                means[f"{tag}_{name}_slam_xy_cm_mean"] = 100 * float(
                    np.mean(errs))
    finally:
        landmarks.FIT_DTYPE = torch.float64
    print(json.dumps({"seeds": args.seeds, "device": args.device, **means}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
