"""SLAM-in-the-loop MPPI: estimate → plan → act, with the EKF's pose (not
ground truth) closing the control loop.

Port of ``tpunav/control/slam_loop.py`` (the reference's
``roslaunch nuslam slam.launch`` feeding ``mppi_waypoints``,
nuslam/src/slam_node.cpp + nuturtle_robot/src/mppi_waypoints_node.cpp).
One tick: EKF pose → waypoint advance → MPPI solve (the fused kernel K1
with ``use_fused``, seeded with ``fused_seed + ticks`` on the device) →
plant → biased odometry → EKF update.

The sensor follows its schedule on the host. ``tpunav`` runs the sensor
chain on every tick and masks it to NaN off schedule; here the host knows
the tick count (``SlamLoopState.host_ticks``, no sync), runs the sensor
(and the lidar → detector chain of a ``meas_fn``) only on sensing ticks,
and runs the filter's prediction alone on the others, which equals the
filter's step on all-NaN rows. The waypoint index, visit count and done
flag stay on the device; ``run_slam_loop`` reads ``done`` once per tick so
it stops on the same tick as ``tpunav``'s ``while_loop``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve
from ..estimation.ekf import filter as ekff
from ..estimation.ekf.filter import (EKFConfig, EKFState, ekf_init,
                                     known_correspondence_slam, robot_pose,
                                     slam_unknown_da)
from ..models.cart import CartParams, kinematic_cart
# A module import: ops.fused_mppi imports control.mppi, so a name import
# here would fail when ops.fused_mppi is imported first.
from ..ops import fused_mppi
from ..ops.rk4 import rk4_step
from ..sim.landmark_sensor import landmark_measurements
from .mppi import MPPIConfig, init_controls, mppi_solve
from .waypoint_loop import _active_waypoint


@dataclasses.dataclass(frozen=True)
class SlamLoopConfig:
    """Closed-loop wiring (``tpunav``'s fields and defaults): the sensor
    schedule, noise injection (the reference's analysis-node fault
    injection, nuslam/launch/landmarks.launch:43-50) and course
    semantics."""

    goal_thresh: float = 0.1
    cycles: int = 1
    tick_dt: float = 1.0 / 60.0
    sensor_every: int = 6             # landmark frames every k-th tick
    visibility: float = 1.2           # sensor range gate (NaN outside)
    meas_noise_std: float = 1e-4
    odom_bias: Tuple[float, float] = (1e-3, 5e-4)   # per-tick (w, vx) bias
    known_da: bool = True
    # Solver backend: False = the plain mppi_solve; True = the fused
    # kernel K1 seeded with fused_seed + tick.
    use_fused: bool = False
    fused_seed: int = 0


class SlamLoopState(NamedTuple):
    true_pose: torch.Tensor   # (3,) [x, y, theta] — plant ground truth
    odom: torch.Tensor        # (3,) [theta, x, y] — dead-reckoning path
    ekf: EKFState             # the filter (its pose feeds MPPI), float32
    u: torch.Tensor           # (N, 2) nominal controls
    generator: torch.Generator  # MPPI perturbations and sensor noise
    wpt_idx: torch.Tensor     # int32
    visits: torch.Tensor      # int32
    ticks: torch.Tensor       # int32 (keys the fused kernel's Philox)
    done: torch.Tensor        # bool
    host_ticks: int           # ticks, on the host: the sensor schedule


def slam_loop_init(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig, pose_xyt=None,
                   seed: int = 0, device=DEFAULT_DEVICE) -> SlamLoopState:
    """The loop's start at ``pose_xyt`` (default the origin) with a
    float32 filter, as ``tpunav``'s, on ``device`` (default the CUDA card;
    raises without CUDA unless ``device="cpu"``)."""
    device = resolve(device)
    pose = (torch.zeros(3, dtype=torch.float32, device=device)
            if pose_xyt is None else
            torch.as_tensor(pose_xyt, dtype=torch.float32).to(device))
    odom = torch.stack([pose[2], pose[0], pose[1]])
    ekf = ekf_init(ekf_cfg, dtype=torch.float32, device=device)
    ekf = ekf._replace(state=torch.cat([odom, ekf.state[3:]]))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=device)
    return SlamLoopState(
        true_pose=pose, odom=odom, ekf=ekf,
        u=init_controls(mppi_cfg, device=device), generator=gen,
        wpt_idx=torch.zeros((), **i32), visits=torch.zeros((), **i32),
        ticks=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=device),
        host_ticks=0)


def slam_loop_tick(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                   cfg: SlamLoopConfig, model: CartParams, waypoints,
                   landmarks, st: SlamLoopState, meas_fn=None,
                   noise: Optional[torch.Tensor] = None,
                   meas_noise: Optional[torch.Tensor] = None
                   ) -> SlamLoopState:
    """One tick: EKF pose → waypoint advance → MPPI solve → plant → noisy
    odometry → EKF SLAM update.

    ``waypoints`` (W, 3) and ``landmarks`` (M, 2): float32 tensors on the
    state's device. ``meas_fn(true_pose_txy, generator) -> (M', 2)``
    replaces the landmark sensor (the dense world's lidar → circle
    detector chain); it runs on sensing ticks only. Parity seams:
    ``noise``, the tick's (N, K, 2) MPPI perturbations (with None the
    plain backend draws from the state's generator and the fused backend
    uses in-kernel Philox), and ``meas_noise``, the sensor's (M, 2)
    standard normals on a sensing tick (with None they are drawn from the
    generator)."""
    slam_step = (known_correspondence_slam if cfg.known_da
                 else slam_unknown_da)
    n_wpts = waypoints.shape[0]

    # The controller sees the FILTER's pose (ref: mppi_waypoints consumes
    # the odometer/slam estimate, never gazebo truth).
    est_txy = robot_pose(st.ekf)                       # [theta, x, y]
    est_xyt = torch.stack([est_txy[1], est_txy[2], est_txy[0]])

    wpt = _active_waypoint(waypoints, st.wpt_idx)
    d2g = torch.hypot(est_xyt[0] - wpt[0], est_xyt[1] - wpt[1])
    arrived = d2g < cfg.goal_thresh
    visits = st.visits + arrived.to(torch.int32)
    wpt_idx = torch.where(arrived, (st.wpt_idx + 1) % n_wpts, st.wpt_idx)
    done = torch.logical_or(st.done, visits >= cfg.cycles * n_wpts)
    wpt = _active_waypoint(waypoints, wpt_idx)

    if cfg.use_fused:
        seed = cfg.fused_seed + st.ticks              # int32, on the device
        cmd, u = fused_mppi.mppi_solve_fused_packed(
            mppi_cfg, model, st.u, seed, est_xyt, wpt, noise)
    else:
        cmd, u = mppi_solve(mppi_cfg, model, st.u, st.generator, est_xyt,
                            wpt, noise=None if noise is None
                            else noise.transpose(0, 1))
    cmd = torch.where(done, torch.zeros_like(cmd), cmd)

    # True plant (ref: fake encoders + odometer chain).
    f = lambda x, uu: kinematic_cart(model, x, uu)
    true_pose = rk4_step(f, st.true_pose, cmd, cfg.tick_dt)
    true_pose = torch.where(done, st.true_pose, true_pose)

    # Biased body displacement over the tick — what odometry reports.
    w_body = (model.wheel_radius / model.wheel_base) * (cmd[1] - cmd[0])
    v_body = 0.5 * model.wheel_radius * (cmd[0] + cmd[1])
    u_odom = torch.stack([w_body * cfg.tick_dt + cfg.odom_bias[0],
                          v_body * cfg.tick_dt + cfg.odom_bias[1]])
    u_odom = torch.where(done, torch.zeros_like(u_odom), u_odom)
    odom = ekff.motion_update(ekf_cfg, st.odom, u_odom,
                              torch.zeros_like(st.odom))

    # Landmark frame on schedule; the prediction alone off schedule.
    if st.host_ticks % cfg.sensor_every == 0:
        true_txy = torch.stack([true_pose[2], true_pose[0], true_pose[1]])
        if meas_fn is None:
            meas = landmark_measurements(
                landmarks, true_txy, cfg.visibility, generator=st.generator,
                noise_std=cfg.meas_noise_std, noise=meas_noise)
        else:
            meas = meas_fn(true_txy, st.generator)
    else:
        meas = st.odom.new_empty((0, 2))
    ekf = slam_step(ekf_cfg, st.ekf, meas, u_odom)

    return st._replace(true_pose=true_pose, odom=odom, ekf=ekf, u=u,
                       wpt_idx=wpt_idx, visits=visits, ticks=st.ticks + 1,
                       done=done, host_ticks=st.host_ticks + 1)


def run_slam_loop(mppi_cfg: MPPIConfig, ekf_cfg: EKFConfig,
                  cfg: SlamLoopConfig, model: CartParams, waypoints,
                  landmarks, st: SlamLoopState,
                  max_ticks: int) -> SlamLoopState:
    """Run the closed loop until the course completes or ``max_ticks``;
    stops on the same tick as ``tpunav``'s ``while_loop`` (one host read
    of ``done`` per tick)."""
    dev = st.true_pose.device
    waypoints = torch.as_tensor(waypoints, dtype=torch.float32).to(dev)
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32).to(dev)
    while st.host_ticks < max_ticks and not bool(st.done):
        st = slam_loop_tick(mppi_cfg, ekf_cfg, cfg, model, waypoints,
                            landmarks, st)
    return st
