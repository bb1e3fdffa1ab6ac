"""End-to-end: EKF SLAM (known and unknown DA) against odometry dead
reckoning.

Counterpart of ``examples/ekf_slam_demo.py``, the port's equivalent of
``roslaunch nuslam slam.launch debug:=true`` (ref: nuslam/src/
slam_node.cpp + analysis_node.cpp): a simulated robot drives an arc
through the 12-cylinder block world; the filter receives biased odometry
and the landmark sensor's measurements; the final pose error against
ground truth stands beside dead-reckoned odometry's (the reference's
README tables, nuslam/README.md:24-50).

    python -m examples_torch.ekf_slam_demo [--device cpu]
"""

from __future__ import annotations

import time

import torch

from examples_torch import device_parser, synchronize
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import (EKFConfig, ekf_init,
                                         known_correspondence_slam,
                                         robot_pose, slam_unknown_da)
from tpunav_torch.estimation.ekf import filter as ekff
from tpunav_torch.sim import landmark_measurements

LANDMARKS = [
    [0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
    [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
    [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]]

# Process noise at the odometry bias's actual scale (the reference's 1e-10
# makes the filter ignore its measurements once dead reckoning drifts).
# Unknown DA needs an honest process/measurement noise balance: with the
# reference's 1e-10 the filter grows so confident that the odometry bias
# pushes the Mahalanobis distances past the gates.
CONFIGS = {
    "known-DA ": (known_correspondence_slam,
                  EKFConfig(num_landmarks=12, spd_repair=False,
                            motion_noise=(1e-6, 1e-6, 1e-6),
                            measurement_noise=(1e-6, 1e-6))),
    "unknownDA": (slam_unknown_da,
                  EKFConfig(num_landmarks=20, dmin=5e1, dmax=1e4,
                            spd_repair=False,
                            motion_noise=(1e-5, 1e-5, 1e-5),
                            measurement_noise=(1e-5, 1e-5))),
}


def run(slam_step, cfg: EKFConfig, steps=400, seed=0, device=DEFAULT_DEVICE):
    """The arc for ``steps`` steps in float32, the sensor's noise (1e-4 m)
    from a generator seeded ``seed``; returns (ekf_err [θ, x, y], odo_err,
    n_tracked, wall, steps), numpy."""
    device = resolve(device)
    f32 = dict(dtype=torch.float32, device=device)
    landmarks = torch.tensor(LANDMARKS, dtype=torch.float32).to(device)
    u_true = torch.tensor([0.03, 0.015], dtype=torch.float32).to(device)
    u_odom = u_true + torch.tensor([0.001, 0.0005],
                                   dtype=torch.float32).to(device)
    zero3 = torch.zeros(3, **f32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    synchronize(device)
    t0 = time.perf_counter()
    true_pose = torch.zeros(3, **f32)
    st = ekf_init(cfg, dtype=torch.float32, device=device)
    odom = st.state
    for _ in range(steps):
        true_pose = ekff.motion_update(cfg, true_pose, u_true, zero3)
        odom = ekff.motion_update(cfg, odom, u_odom, zero3)
        meas = landmark_measurements(landmarks, true_pose, 1.0,
                                     generator=gen, noise_std=1e-4)
        st = slam_step(cfg, st, meas, u_odom)
    synchronize(device)
    wall = time.perf_counter() - t0
    return ((robot_pose(st) - true_pose).cpu().numpy(),
            (odom[:3] - true_pose).cpu().numpy(), int(st.count), wall, steps)


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    for name, (step_fn, cfg) in CONFIGS.items():
        ekf_err, odo_err, n_lm, wall, steps = run(step_fn, cfg,
                                                  device=args.device)
        print(f"{name}: slam_err(theta,x,y)="
              f"{[f'{float(v):+.4f}' for v in ekf_err]} "
              f"odom_err={[f'{float(v):+.4f}' for v in odo_err]} "
              f"landmarks={n_lm} ({steps} steps in {wall:.1f}s on "
              f"{args.device})")


if __name__ == "__main__":
    main()
