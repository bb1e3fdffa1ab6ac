"""BASELINE config 4 at its stated scale, through the real perception
chain: a 44-cylinder dense world, lidar raycast → clustering +
algebraic-circle-fit detector → unknown-DA (Mahalanobis-gated) EKF at
capacity 50, in a closed loop with MPPI (kernel K1) driving the waypoints
off the filter's pose estimate.

Counterpart of ``examples/dense_world_slam_demo.py``. This is the chain
the reference's unknown-DA table was produced with — scan →
featureDetection → TurtleMap (ref: nuslam/src/landmarks_node.cpp:84-104)
into EKF::SLAM (ref: nuslam/src/slam_node.cpp:240-243, gating dmin/dmax)
— at about four times its 12-landmark world, checking the capacity-50
gating chain through perception rather than oracle feeds.

    python -m examples_torch.dense_world_slam_demo [--device cpu]

``tpunav`` compiles the course as one ``lax.scan``; here ``course`` replays
chunks of that scan as CUDA graphs (``control.slam_loop.run_slam_course``,
the EKF update in its masked form, the detector's eigensolver the port's
kernel), bit for bit the eager per-tick loop, which ``chunked=False``
runs. ``run_batch`` runs its seeds as ``tpunav`` vmaps its course:
``build_batch``'s course replays chunks of all B seeds' ticks
(``control.slam_loop.run_slam_course`` on a seed batch), each tick one K1
launch for the B solves and the detector one call for the B scans, every
seed bit for bit its own ``course``.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from examples_torch import device_parser, draw, out_path, synchronize
from tpunav_torch import batch
from tpunav_torch.control.mppi import MPPIConfig
from tpunav_torch.control.slam_loop import (SlamLoopConfig, run_slam_course,
                                            slam_batch_init, slam_loop_init,
                                            slam_loop_tick)
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.ekf import EKFConfig, EKFState, robot_pose
from tpunav_torch.estimation.landmarks import (LandmarkConfig,
                                               circles_to_measurements,
                                               feature_detection)
from tpunav_torch.models.cart import CartParams
from tpunav_torch.sim.lidar import scan_cylinders

CYL_RADIUS = 0.04          # under the detector's radius_thresh=0.05 gate
SCAN_NOISE = 1e-3          # lidar range noise [m]
MODEL = CartParams(0.033, 0.160)


def dense_world(n_outer=24, n_inner=20, r_outer=1.55, r_inner=0.95):
    """44 cylinders in two concentric rings, (44, 2) float32 numpy; the
    robot's waypoint circle threads between them (≥40 landmarks — the
    config-4 scale)."""
    ao = np.linspace(0.0, 2 * np.pi, n_outer, endpoint=False)
    ai = np.linspace(0.0, 2 * np.pi, n_inner, endpoint=False) + 0.13
    return np.concatenate([
        np.stack([r_outer * np.cos(ao), r_outer * np.sin(ao)], -1),
        np.stack([r_inner * np.cos(ai), r_inner * np.sin(ai)], -1),
    ]).astype(np.float32)


def waypoint_ring(n=12, r_in=1.12, r_out=1.42):
    """(12, 3) float32 waypoints weaving between the two cylinder rings
    (alternating radii): the detector needs ≥4 beams on a cylinder (≈1.1 m
    effective range at 1° spacing, ref min_points landmarks.cpp:253), so a
    course that alternately hugs each ring brings most of the 44 cylinders
    inside detection range during a cycle."""
    a = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = np.where(np.arange(n) % 2 == 0, r_out, r_in)
    th = a + np.pi / 2  # tangent heading
    return np.stack([r * np.cos(a), r * np.sin(a), th], -1).astype(
        np.float32)


def configs(rollouts=2048):
    """(mppi_cfg, ekf_cfg, loop_cfg) of config 4.

    R sets the scale of both Mahalanobis gates (d² ∝ innovation²/R; ref
    gates nuslam/src/slam_node.cpp:240-243): the tight R=1e-5 with these
    gates keeps adds and updates apart at this world's 0.28–0.30 m
    spacing, and dmax=3e3 makes "add" need ≈0.25 m of innovation, under
    the inner ring's spacing. tick_dt equals the solver's dt, so each
    solve's first control is executed for exactly one plan step; the
    odometry bias gives ≈0.4 m / 20° of drift over the course, the
    reference's dead-reckoning scale (nuslam/README.md:44)."""
    mppi = MPPIConfig(horizon=0.4, dt=0.05, rollouts=rollouts, ul_var=4.0,
                      ur_var=4.0)
    ekf = EKFConfig(num_landmarks=50, dmin=5e1, dmax=3e3, spd_repair=False,
                    motion_noise=(1e-5, 1e-5, 1e-5),
                    measurement_noise=(1e-5, 1e-5))
    loop = SlamLoopConfig(goal_thresh=0.15, cycles=2, sensor_every=4,
                          tick_dt=0.05, odom_bias=(1e-4, 1e-4),
                          known_da=False, use_fused=True)
    return mppi, ekf, loop


class _Pose(NamedTuple):
    """What :func:`errors` reads of a state: one seed's fields."""

    ekf: EKFState
    true_pose: torch.Tensor
    odom: torch.Tensor


def errors(st):
    """The filter's and odometry's pose errors [θ, x, y] against the
    plant's truth."""
    est, tru = robot_pose(st.ekf), st.true_pose
    e_s = torch.stack([normalize_angle_pi(est[0] - tru[2]),
                       est[1] - tru[0], est[2] - tru[1]])
    e_o = torch.stack([normalize_angle_pi(st.odom[0] - tru[2]),
                       st.odom[1] - tru[0], st.odom[2] - tru[1]])
    return e_s, e_o


def telemetry_row(st):
    """A tick's telemetry (5,): SLAM |xy| and yaw error, odometry |xy|
    and yaw error, tracked count (the scan's per-tick output of
    ``tpunav``'s course)."""
    e_s, e_o = errors(st)
    return torch.stack([torch.hypot(e_s[1], e_s[2]), e_s[0],
                        torch.hypot(e_o[1], e_o[2]), e_o[0],
                        st.ekf.count.to(torch.float32)])


def build(steps=5000, rollouts=2048, device=DEFAULT_DEVICE):
    """Returns (course, configs, waypoints, landmarks, meas_fn):
    ``course(seed, telemetry=True, chunked=True)`` runs ``steps`` ticks
    from the ring's first waypoint and returns the final errors [θ, x, y]
    (SLAM and odometry), the tracked count, the visits, per-tick telemetry
    (steps, 5: SLAM |xy| and yaw error, odometry |xy| and yaw error,
    tracked count; None without ``telemetry``; ``tel_t``, the same rows as
    a tensor on the device), the landmark estimates, the filter's active
    slots, the final state, and the seconds the ticks took (``wall_s``,
    from a synchronize after the start to one after the last tick, with
    the telemetry where it is taken). ``chunked``: through
    ``run_slam_course`` (graph chunks on the card), else the eager
    per-tick loop. ``meas_fn(true_txy, generator, noise=None)``: the lidar
    → detector chain; ``noise``, the scan's (360,) standard normals,
    replaces the draw from ``generator``."""
    device = resolve(device)
    mppi, ekf, loop = configs(rollouts)
    landmarks = torch.from_numpy(dense_world()).to(device)
    radii = torch.full((landmarks.shape[0],), CYL_RADIUS,
                       dtype=torch.float32, device=device)
    waypoints = torch.from_numpy(waypoint_ring()).to(device)
    lm_cfg = LandmarkConfig(max_clusters=32)

    def meas_fn(true_txy, generator, noise=None):
        ranges = scan_cylinders(true_txy, landmarks, radii,
                                generator=generator, noise_std=SCAN_NOISE,
                                noise=noise)
        return circles_to_measurements(feature_detection(lm_cfg, ranges))

    def course(seed, telemetry=True, chunked=True):
        st = slam_loop_init(mppi, ekf, pose_xyt=[1.42, 0.0, math.pi / 2],
                            seed=int(seed), device=device)
        tel = []
        synchronize(device)
        t0 = time.perf_counter()
        if chunked:
            st, tel = run_slam_course(
                mppi, ekf, loop, MODEL, waypoints, landmarks, st, steps,
                meas_fn=meas_fn, meas_shape=(360,),
                telemetry=telemetry_row if telemetry else None)
        else:
            for _ in range(steps):
                st = slam_loop_tick(mppi, ekf, loop, MODEL, waypoints,
                                    landmarks, st, meas_fn=meas_fn)
                if telemetry:
                    tel.append(telemetry_row(st))
            tel = torch.stack(tel) if telemetry else None
        synchronize(device)
        wall = time.perf_counter() - t0
        e_s, e_o = errors(st)
        return dict(ekf_err=e_s.cpu().numpy(), odo_err=e_o.cpu().numpy(),
                    count=int(st.ekf.count), visits=int(st.visits),
                    tel=tel.cpu().numpy() if telemetry else None, tel_t=tel,
                    wall_s=wall,
                    lms=st.ekf.state[3:].reshape(-1, 2).cpu().numpy(),
                    lm_active=st.ekf.active.cpu().numpy(), state=st)

    return course, (mppi, ekf, loop), waypoints, landmarks, meas_fn


def build_batch(steps=5000, rollouts=2048, device=DEFAULT_DEVICE):
    """:func:`build`'s course over a seed batch: ``course_batch(seeds,
    telemetry=True)`` runs the course for every seed of the list at once
    (``run_slam_course`` on ``slam_batch_init``'s state) and returns
    :func:`build`'s course's dict with every array leading with B,
    ``state`` the batch's state and ``wall_s`` the seconds of the whole
    batch. Seed i gives the bits of ``build(...)[0](seeds[i])``."""
    device = resolve(device)
    _, (mppi, ekf, loop), waypoints, landmarks, meas_fn = build(
        steps, rollouts, device)

    def course_batch(seeds, telemetry=True):
        st = slam_batch_init(mppi, ekf, seeds,
                             pose_xyt=[1.42, 0.0, math.pi / 2], device=device)
        synchronize(device)
        t0 = time.perf_counter()
        st, tel = run_slam_course(
            mppi, ekf, loop, MODEL, waypoints, landmarks, st, steps,
            meas_fn=meas_fn, meas_shape=(360,),
            telemetry=telemetry_row if telemetry else None)
        synchronize(device)
        wall = time.perf_counter() - t0
        e_s, e_o = batch.vmap(lambda *f: errors(_Pose(*f)))(
            st.ekf, st.true_pose, st.odom)
        return dict(ekf_err=e_s.cpu().numpy(), odo_err=e_o.cpu().numpy(),
                    count=st.ekf.count.cpu().numpy(),
                    visits=st.visits.cpu().numpy(),
                    tel=tel.cpu().numpy() if telemetry else None, tel_t=tel,
                    wall_s=wall,
                    lms=st.ekf.state[:, 3:].reshape(len(seeds), -1, 2)
                    .cpu().numpy(),
                    lm_active=st.ekf.active.cpu().numpy(), state=st)

    return course_batch


def run(seed=0, steps=5000, rollouts=2048, device=DEFAULT_DEVICE):
    """One seed; returns (ekf_err [θ, x, y], odo_err, n_tracked, wall,
    steps, telemetry)."""
    device = resolve(device)
    out = build(steps, rollouts, device)[0](seed)
    return (out["ekf_err"], out["odo_err"], out["count"], out["wall_s"],
            steps, out["tel"])


def run_batch(seeds, steps=5000, rollouts=2048, device=DEFAULT_DEVICE):
    """The course over all ``seeds`` at once (:func:`build_batch`); returns
    ({ekf_err (S, 3), odo_err (S, 3), count (S,), visits (S,)}, wall
    seconds, the chunks' warm-ups and captures included). Seed i's numbers
    are those of its own course, ``build(...)[0](seeds[i])``."""
    device = resolve(device)
    course_batch = build_batch(steps, rollouts, device)
    t0 = time.perf_counter()
    out = course_batch([int(s) for s in seeds], telemetry=False)
    return ({key: np.asarray(out[key]) for key in
             ("ekf_err", "odo_err", "count", "visits")},
            time.perf_counter() - t0)


def plot(tel):
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
        out_path("dense_world_slam.png"),
        title="dense world (44 cylinders): lidar→detector→unknown-DA EKF"
              " + MPPI")
    print("wrote", out)


def main():
    args = device_parser(__doc__.splitlines()[0]).parse_args()
    ekf_err, odo_err, n_lm, wall, steps, tel = run(device=args.device)
    print(f"dense-world unknown-DA: slam_err(theta,x,y)="
          f"{[f'{float(v):+.4f}' for v in ekf_err]} "
          f"odom_err={[f'{float(v):+.4f}' for v in odo_err]} "
          f"landmarks={n_lm}/44 ({steps} steps in {wall:.1f}s on "
          f"{args.device})")
    draw(plot, tel)


if __name__ == "__main__":
    main()
