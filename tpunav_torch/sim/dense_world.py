"""BASELINE config 4 as a deployment: the dense world, its waypoint ring,
the loop's configurations and the lidar → detector sensor chain.

Config 4 is the unknown-DA EKF SLAM loop at its stated scale: a
44-cylinder world, 360-beam lidar raycast → clustering and algebraic
circle fit → unknown-DA (Mahalanobis-gated) EKF at capacity 50, closed
with MPPI (kernel K1) driving the waypoints off the filter's pose. It is
the chain the reference's unknown-DA table was produced with — scan →
featureDetection → TurtleMap (ref: nuslam/src/landmarks_node.cpp:84-104)
into EKF::SLAM (ref: nuslam/src/slam_node.cpp:240-243, gating dmin/dmax)
— at about four times its 12-landmark world.

:func:`deployment` gives everything a course needs on a device;
``examples_torch/dense_world_slam_demo.py`` and the benchmark's sweep
build the loop from it (``control.slam_loop``: ``run_slam_course`` or a
``SlamCourseRunner``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..control.mppi import MPPIConfig
from ..control.slam_loop import SlamLoopConfig
from ..device import DEFAULT_DEVICE, resolve
from ..estimation.ekf import EKFConfig
from ..estimation.landmarks import (LandmarkConfig, circles_to_measurements,
                                    feature_detection)
from ..models.cart import CartParams
from .lidar import scan_cylinders

CYL_RADIUS = 0.04          # under the detector's radius_thresh=0.05 gate
SCAN_NOISE = 1e-3          # lidar range noise [m]
NUM_BEAMS = 360            # one beam a degree (LDS-01)
MAX_CLUSTERS = 32          # the detector's output slots: measurement rows
MODEL = CartParams(0.033, 0.160)
START = (1.42, 0.0, math.pi / 2)   # [x, y, θ]: the ring's first waypoint


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


def sensor(landmarks: torch.Tensor) -> Callable:
    """The lidar → detector chain over the cylinders at ``landmarks`` (M,
    2): ``meas_fn(true_txy, generator, noise=None)`` gives the (32, 2)
    robot-frame circle centres, NaN rows for empty slots; ``noise``, the
    scan's (360,) standard normals, replaces the draw from
    ``generator``."""
    radii = torch.full((landmarks.shape[0],), CYL_RADIUS,
                       dtype=torch.float32, device=landmarks.device)
    lm_cfg = LandmarkConfig(max_clusters=MAX_CLUSTERS)

    def meas_fn(true_txy, generator, noise=None):
        ranges = scan_cylinders(true_txy, landmarks, radii,
                                num_beams=NUM_BEAMS, generator=generator,
                                noise_std=SCAN_NOISE, noise=noise)
        return circles_to_measurements(feature_detection(lm_cfg, ranges))

    return meas_fn


class Deployment(NamedTuple):
    """What a config-4 course needs, on one device."""

    mppi: MPPIConfig
    ekf: EKFConfig
    loop: SlamLoopConfig
    model: CartParams
    waypoints: torch.Tensor      # (12, 3) float32
    landmarks: torch.Tensor      # (44, 2) float32
    meas_fn: Callable
    meas_shape: Tuple[int, ...]  # the normals a sensing tick draws
    start: Tuple[float, float, float]


def deployment(rollouts=2048, device=DEFAULT_DEVICE) -> Deployment:
    """Config 4 on ``device`` (default the CUDA card; raises without CUDA
    unless ``device="cpu"``)."""
    device = resolve(device)
    mppi, ekf, loop = configs(rollouts)
    landmarks = torch.from_numpy(dense_world()).to(device)
    return Deployment(mppi, ekf, loop, MODEL,
                      torch.from_numpy(waypoint_ring()).to(device),
                      landmarks, sensor(landmarks), (NUM_BEAMS,), START)
