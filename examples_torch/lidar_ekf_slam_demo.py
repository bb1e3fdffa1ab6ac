"""End-to-end perception: lidar raycast → circle detector → EKF SLAM.

Counterpart of ``examples/lidar_ekf_slam_demo.py``. The reference's
non-debug SLAM pipeline — scan → featureDetection → TurtleMap (ref:
nuslam/src/landmarks_node.cpp:84-104) feeding the EKF node (ref:
nuslam/src/slam_node.cpp:109-123) — closed end to end with no ground-truth
landmark sensor: the robot drives a loop through the 12-cylinder block
world, and every measurement the filter sees comes from ``scan_cylinders``
raycasts through the clustering and algebraic-circle-fit detector.
Reported as the reference README's tables are (nuslam/README.md:24-50):
final SLAM pose error beside dead-reckoned odometry error, for known DA
(through the sim-side correspondence oracle) and unknown DA (Mahalanobis
gating on raw detections).

    python -m examples_torch.lidar_ekf_slam_demo [--device cpu]

The seed enters only the scan noise; the filter is deterministic
(``generator=None``). ``run_many`` loops over seeds where ``tpunav`` vmaps
its course: each EKF update reads its count of valid measurements on the
host, and the detector's ``eigh`` reads its error code, so the course is a
host loop that ``torch.func.vmap`` cannot batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from examples_torch import device_parser, draw, out_path, synchronize
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import (EKFConfig, ekf_init,
                                         known_correspondence_slam,
                                         robot_pose, slam_unknown_da)
from tpunav_torch.estimation.ekf import filter as ekff
from tpunav_torch.estimation.landmarks import (LandmarkConfig,
                                               circles_to_measurements,
                                               feature_detection)
from tpunav_torch.sim import associate_known, scan_cylinders

# Block-world cylinders (ref: nuslam/config/block_world_landmarks.yaml).
LANDMARKS = [
    [0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
    [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
    [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]]
CYL_RADIUS = 0.04          # under the detector's radius_thresh=0.05 gate
SCAN_NOISE = 1e-3          # lidar range noise [m]
U_TRUE = (0.03, 0.015)
BIAS = (0.001, 0.0005)

# The demo's two filters: known DA at 12 slots, and BASELINE config 4's
# unknown DA at 50-landmark capacity.
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


def make_sim(slam_step, cfg: EKFConfig, known: bool, steps=400,
             device=DEFAULT_DEVICE):
    """The closed-loop course ``sim(seed, noise=None) → (true_pose, odom,
    ekf_state, telemetry)`` on ``device``, in float32. Per step: truth and
    biased odometry through ``motion_update``, a 360-beam scan (range
    noise from a generator seeded ``seed``, or ``noise[i]``, the step's
    (360,) standard normals), the detector, the known-DA oracle when
    ``known``, and ``slam_step``. The telemetry (steps, 5) holds SLAM |xy|
    and yaw error, odometry |xy| and yaw error, and the tracked count."""
    device = resolve(device)
    f32 = dict(dtype=torch.float32, device=device)
    lm_cfg = LandmarkConfig(max_clusters=16)
    landmarks = torch.tensor(LANDMARKS, dtype=torch.float32).to(device)
    radii = torch.full((len(LANDMARKS),), CYL_RADIUS, **f32)
    u_true = torch.tensor(U_TRUE, dtype=torch.float32).to(device)
    u_odom = u_true + torch.tensor(BIAS, dtype=torch.float32).to(device)
    zero3 = torch.zeros(3, **f32)

    def sim(seed: int, noise=None):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        true_pose = torch.zeros(3, **f32)
        st = ekf_init(cfg, dtype=torch.float32, device=device)
        odom = st.state
        tel = []
        for i in range(steps):
            true_pose = ekff.motion_update(cfg, true_pose, u_true, zero3)
            odom = ekff.motion_update(cfg, odom, u_odom, zero3)
            ranges = scan_cylinders(true_pose, landmarks, radii,
                                    generator=gen, noise_std=SCAN_NOISE,
                                    noise=None if noise is None
                                    else noise[i])
            meas = circles_to_measurements(feature_detection(lm_cfg, ranges))
            if known:
                meas = associate_known(meas, landmarks, true_pose)
            st = slam_step(cfg, st, meas, u_odom)
            e_s = robot_pose(st) - true_pose
            e_o = odom[:3] - true_pose
            tel.append(torch.stack([
                torch.hypot(e_s[1], e_s[2]), normalize_angle_pi(e_s[0]),
                torch.hypot(e_o[1], e_o[2]), normalize_angle_pi(e_o[0]),
                st.count.to(torch.float32)]))
        return true_pose, odom, st, torch.stack(tel)

    return sim


def _wrapped(e):
    e = e.cpu().numpy().astype(np.float64)
    e[0] = (e[0] + np.pi) % (2 * np.pi) - np.pi
    return e


def run(slam_step, cfg: EKFConfig, known: bool, steps=400, seed=0,
        device=DEFAULT_DEVICE):
    """One seed; returns (ekf_err [θ, x, y], odo_err, n_tracked, wall,
    steps, telemetry (steps, 5)), numpy."""
    device = resolve(device)
    sim = make_sim(slam_step, cfg, known, steps, device)
    synchronize(device)
    t0 = time.perf_counter()
    true_pose, odom, st, tel = sim(seed)
    synchronize(device)
    wall = time.perf_counter() - t0
    return (_wrapped(robot_pose(st) - true_pose),
            _wrapped(odom[:3] - true_pose),
            int(st.count), wall, steps, tel.cpu().numpy())


def run_many(slam_step, cfg: EKFConfig, known: bool, seeds, steps=400,
             device=DEFAULT_DEVICE):
    """The course once per seed; returns per-seed (ekf_err (S, 3) [θ, x,
    y], odo_err (S, 3), counts (S,)) and the wall seconds of the sweep."""
    device = resolve(device)
    sim = make_sim(slam_step, cfg, known, steps, device)
    errs, odos, counts = [], [], []
    t0 = time.perf_counter()
    for seed in seeds:
        true_pose, odom, st, _ = sim(int(seed))
        errs.append(_wrapped(robot_pose(st) - true_pose))
        odos.append(_wrapped(odom[:3] - true_pose))
        counts.append(int(st.count))
    return (np.asarray(errs), np.asarray(odos), np.asarray(counts),
            time.perf_counter() - t0)


def plot(tel, tag):
    """The per-step stream → an rqt_plot-style panel."""
    from tpunav_torch.viz import plot_series

    out = plot_series(
        {"SLAM |xy| err [cm]": tel[:, 0] * 100,
         "odometry |xy| err [cm]": tel[:, 2] * 100,
         "SLAM yaw err [deg]": np.degrees(tel[:, 1]),
         "odometry yaw err [deg]": np.degrees(tel[:, 3]),
         "tracked landmarks": tel[:, 4]},
        [("cm", ["SLAM |xy| err [cm]", "odometry |xy| err [cm]"]),
         ("deg", ["SLAM yaw err [deg]", "odometry yaw err [deg]"]),
         ("count", ["tracked landmarks"])],
        out_path(f"lidar_ekf_{tag}_timeseries.png"),
        title=f"lidar → detector → EKF SLAM ({tag} DA)", xlabel="step")
    print(f"  wrote {out}")


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    for tag, (step_fn, known, cfg) in CONFIGS.items():
        ekf_err, odo_err, n_lm, wall, steps, tel = run(step_fn, cfg, known,
                                                       device=args.device)
        print(f"lidar {tag:7s} DA: slam_err(theta,x,y)="
              f"{[f'{float(v):+.4f}' for v in ekf_err]} "
              f"odom_err={[f'{float(v):+.4f}' for v in odo_err]} "
              f"landmarks={n_lm} ({steps} steps in {wall:.1f}s on "
              f"{args.device})")
        draw(plot, tel, tag)


if __name__ == "__main__":
    main()
