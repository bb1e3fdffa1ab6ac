"""End-to-end: EKF SLAM (known and unknown DA) against odometry dead
reckoning.

Counterpart of ``examples/ekf_slam_demo.py``, the port's equivalent of
``roslaunch nuslam slam.launch debug:=true`` (ref: nuslam/src/
slam_node.cpp + analysis_node.cpp): a simulated robot drives an arc
through the 12-cylinder block world; the filter receives biased odometry
and the landmark sensor's measurements; the final pose error against
ground truth stands beside dead-reckoned odometry's (the reference's
README tables, nuslam/README.md:24-50). Where ``tpunav`` jits the course
as one ``lax.scan``, each step replays one CUDA graph
(``lidar_ekf_slam_demo.StepGraph``) with the EKF's masked update;
``make_course(..., eager=True)`` calls the dynamic update, operation by
operation.

    python -m examples_torch.ekf_slam_demo [--device cpu]
"""

from __future__ import annotations

import time

import torch

from examples_torch import device_parser, synchronize
from examples_torch.lidar_ekf_slam_demo import (StepGraph, course,
                                                eager_course, known_da)
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import (EKFConfig, ekf_init,
                                         known_correspondence_slam,
                                         robot_pose, slam_unknown_da)
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


def _course_parts(device):
    """(sense, u_true, u_odom): ``sense(true_pose, generator=None,
    noise=None)`` → the landmark sensor's (12, 2) measurements (1e-4 m
    noise, 1 m visibility), and the two twists."""
    landmarks = torch.tensor(LANDMARKS, dtype=torch.float32).to(device)
    u_true = torch.tensor([0.03, 0.015], dtype=torch.float32).to(device)
    u_odom = u_true + torch.tensor([0.001, 0.0005],
                                   dtype=torch.float32).to(device)

    def sense(true_pose, generator=None, noise=None):
        return landmark_measurements(landmarks, true_pose, 1.0,
                                     generator=generator, noise_std=1e-4,
                                     noise=noise)

    return sense, u_true, u_odom


def make_graph(slam_step, cfg: EKFConfig, device=DEFAULT_DEVICE):
    """The arc's ``lidar_ekf_slam_demo.StepGraph``: the landmark sensor in
    place of the scan and the detector, its 12 rows into ``slam_step``'s
    masked form."""
    device = resolve(device)
    sense, u_true, u_odom = _course_parts(device)
    return StepGraph(cfg, known_da(slam_step),
                     lambda pose, z: sense(pose, noise=z),
                     (len(LANDMARKS), 2), len(LANDMARKS),
                     ekf_init(cfg, dtype=torch.float32, device=device),
                     u_true, u_odom, device)


def make_course(slam_step, cfg: EKFConfig, steps=400,
                device=DEFAULT_DEVICE, eager=False):
    """The arc ``course(seed) → (true_pose, odom, ekf_state)`` for
    ``steps`` steps in float32 on ``device``, the sensor's noise (1e-4 m)
    from a generator seeded ``seed``. Each step is one replay of
    :func:`make_graph`'s graph; every call loads its start into that one
    graph. With ``eager`` the step's operations run one by one,
    ``slam_step`` itself (the dynamic form, or a masked one as the graph's
    bits reference)."""
    device = resolve(device)
    if not eager:
        graph = make_graph(slam_step, cfg, device)
        return lambda seed: course(graph, cfg, seed, steps)[:3]
    parts = _course_parts(device)
    return lambda seed: eager_course(slam_step, cfg, *parts, seed,
                                     steps)[:3]


def run(slam_step, cfg: EKFConfig, steps=400, seed=0,
        device=DEFAULT_DEVICE):
    """The arc for ``steps`` steps (:func:`make_course`); returns (ekf_err
    [θ, x, y], odo_err, n_tracked, wall, steps), numpy. ``wall`` includes
    the graph's warm-up and capture."""
    device = resolve(device)
    course_fn = make_course(slam_step, cfg, steps, device)
    synchronize(device)
    t0 = time.perf_counter()
    true_pose, odom, st = course_fn(seed)
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
