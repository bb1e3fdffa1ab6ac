"""Waypoint-following control loop with the waypoint manager on the device.

Port of ``tpunav/control/waypoint_loop.py``. The waypoint index, visit
counter and done flag are tensors advanced with tensor ops inside the
tick (``torch.where``, a device index), so a tick makes no host sync on
either backend: the plain solver (``control/mppi.py``) or the fused CUDA
kernel (``ops/fused_mppi.py``). ``run_course_chunked`` syncs once per
chunk; ``run_course`` reads ``done`` once per tick so it stops on the same
tick as ``tpunav``'s ``while_loop``.

Obstacles (BASELINE config 2) enter as in ``tpunav``: the plain backend
takes an ``extra_cost`` (``control/obstacle_cost.py``), the fused backend
``obstacles``/``obs_cfg`` for the kernel's obstacle mode. A course packs
the obstacle table once, not once per tick: a host-to-device copy per
tick would wait for the card's queue to drain.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve
from ..models.cart import CartParams, kinematic_cart
from ..ops.fused_mppi import mppi_solve_fused_packed, pack_obstacles
from ..ops.rk4 import rk4_step
from ..sim.motor import MotorParams, track
from .mppi import MPPIConfig, init_controls, mppi_solve


@dataclasses.dataclass(frozen=True)
class CourseConfig:
    """Waypoint-cycling semantics (same fields as ``tpunav``'s)."""

    goal_thresh: float = 0.1
    cycles: int = 1              # full passes through the list, then stop
    tick_dt: float = 1.0 / 60.0  # plant update rate (60 Hz)
    max_ticks: int = 100_000
    # Solver backend: False = the plain mppi_solve; True = the fused CUDA
    # kernel, whose in-kernel Philox stream is keyed by fused_seed + tick.
    use_fused: bool = False
    fused_seed: int = 0
    # Plant motor dynamics; τ=0 is ideal tracking.
    motor: MotorParams = MotorParams()


class CourseState(NamedTuple):
    pose: torch.Tensor       # (3,) [x, y, theta] float32
    u: torch.Tensor          # (N, 2) nominal controls
    seed: int                # the generator's seed
    generator: torch.Generator  # the plain backend's perturbation stream
    wpt_idx: torch.Tensor    # int32
    visits: torch.Tensor     # int32 — waypoints reached so far
    ticks: torch.Tensor      # int32
    done: torch.Tensor       # bool
    wheel_vel: torch.Tensor  # (2,) actual wheel velocities (motor state)


def course_init(cfg: MPPIConfig, pose, seed: int = 0,
                device=DEFAULT_DEVICE) -> CourseState:
    pose = torch.as_tensor(pose, dtype=torch.float32, device=resolve(device))
    device = pose.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    i32 = dict(dtype=torch.int32, device=device)
    return CourseState(
        pose=pose, u=init_controls(cfg, device=device), seed=seed,
        generator=gen,
        wpt_idx=torch.zeros((), **i32), visits=torch.zeros((), **i32),
        ticks=torch.zeros((), **i32),
        done=torch.zeros((), dtype=torch.bool, device=device),
        wheel_vel=torch.zeros(2, dtype=torch.float32, device=device))


def _active_waypoint(waypoints, idx):
    """waypoints[idx] through a device index (no host read of idx)."""
    return torch.index_select(waypoints, 0, idx.reshape(1))[0]


def _dist_to_goal(pose, wpt):
    return torch.hypot(pose[0] - wpt[0], pose[1] - wpt[1])


def _obstacle_table(course: CourseConfig, st: CourseState, extra_cost,
                    obstacles, obs_cfg):
    """``tpunav``'s guards, then the packed obstacle table on the state's
    device (None without obstacles)."""
    if course.use_fused and extra_cost is not None:
        raise ValueError(
            "extra_cost is plain-path only; with use_fused=True pass the "
            "kernel's obstacles/obs_cfg instead")
    if not course.use_fused and (obstacles is not None or
                                 obs_cfg is not None):
        raise ValueError(
            "obstacles/obs_cfg are fused-kernel only; with use_fused=False "
            "pass extra_cost (control/obstacle_cost.py)")
    return pack_obstacles(obstacles, obs_cfg, st.pose.device)


def course_tick(cfg: MPPIConfig, course: CourseConfig, model: CartParams,
                waypoints, st: CourseState, extra_cost=None,
                obstacles=None, obs_cfg=None,
                noise: Optional[torch.Tensor] = None) -> CourseState:
    """One control tick: waypoint advance → MPPI solve → plant step.

    ``waypoints``: (W, 3) float32 tensor of [x, y, theta] targets on the
    state's device. ``extra_cost`` (plain backend) or ``obstacles`` with
    ``obs_cfg`` (fused backend) add the obstacle cost. ``noise``: optional
    (N, K, 2) perturbations for this tick (a parity-test seam): with None
    the plain backend draws from the state's generator and the fused
    backend uses in-kernel Philox.
    """
    table = _obstacle_table(course, st, extra_cost, obstacles, obs_cfg)
    return _tick(cfg, course, model, waypoints, st, extra_cost, table, noise)


def _tick(cfg: MPPIConfig, course: CourseConfig, model: CartParams,
          waypoints, st: CourseState, extra_cost, table,
          noise=None) -> CourseState:
    """:func:`course_tick` with the obstacle table already packed."""
    n_wpts = waypoints.shape[0]
    d2g = _dist_to_goal(st.pose, _active_waypoint(waypoints, st.wpt_idx))

    # Advance on arrival; cyclic with a total-visit stop.
    arrived = d2g < course.goal_thresh
    visits = st.visits + arrived.to(torch.int32)
    wpt_idx = torch.where(arrived, (st.wpt_idx + 1) % n_wpts, st.wpt_idx)
    done = torch.logical_or(st.done, visits >= course.cycles * n_wpts)
    wpt = _active_waypoint(waypoints, wpt_idx)

    if course.use_fused:
        seed = course.fused_seed + st.ticks          # int32, on the device
        cmd, u = mppi_solve_fused_packed(cfg, model, st.u, seed, st.pose,
                                         wpt, noise, table)
    else:
        cmd, u = mppi_solve(cfg, model, st.u, st.generator, st.pose, wpt,
                            extra_cost, noise=None if noise is None
                            else noise.transpose(0, 1))
    cmd = torch.where(done, torch.zeros_like(cmd), cmd)

    # Motor dynamics between command and plant (τ=0 → wheel_vel == cmd).
    wheel_vel = track(course.motor, st.wheel_vel, cmd, course.tick_dt)
    f = lambda x, uu: kinematic_cart(model, x, uu)
    pose = rk4_step(f, st.pose, wheel_vel, course.tick_dt)
    pose = torch.where(done, st.pose, pose)

    return st._replace(pose=pose, u=u, wpt_idx=wpt_idx, visits=visits,
                       ticks=st.ticks + 1, done=done,
                       wheel_vel=torch.where(done, st.wheel_vel, wheel_vel))


def _waypoints_on(st: CourseState, waypoints):
    return torch.as_tensor(waypoints, dtype=torch.float32,
                           device=st.pose.device)


def run_course(cfg: MPPIConfig, course: CourseConfig, model: CartParams,
               waypoints, st: CourseState, extra_cost=None, obstacles=None,
               obs_cfg=None) -> CourseState:
    """Run ticks until the course completes or ``max_ticks``; stops on the
    same tick as ``tpunav``'s ``while_loop`` (one host read per tick)."""
    table = _obstacle_table(course, st, extra_cost, obstacles, obs_cfg)
    waypoints = _waypoints_on(st, waypoints)
    ticks = int(st.ticks)
    while ticks < course.max_ticks and not bool(st.done):
        st = _tick(cfg, course, model, waypoints, st, extra_cost, table)
        ticks += 1
    return st


def run_course_chunked(cfg: MPPIConfig, course: CourseConfig,
                       model: CartParams, waypoints, st: CourseState,
                       chunk: int = 120, extra_cost=None, obstacles=None,
                       obs_cfg=None, on_chunk=None) -> CourseState:
    """Like :func:`run_course` but syncs to the host every ``chunk`` ticks.

    ``on_chunk(state, telemetry)`` is called with each chunk's end state;
    ``telemetry`` is a dict of per-tick tensors {"pose": (chunk, 3),
    "wpt_idx": (chunk,), "d2g": (chunk,)}. Rows are PRE-tick samples:
    row i is the state tick i saw, so the stream starts at the initial
    state and the final post-tick pose is only in the returned state."""
    table = _obstacle_table(course, st, extra_cost, obstacles, obs_cfg)
    waypoints = _waypoints_on(st, waypoints)
    while True:
        tel = {"pose": [], "wpt_idx": [], "d2g": []}
        for _ in range(chunk):
            tel["pose"].append(st.pose)
            tel["wpt_idx"].append(st.wpt_idx)
            tel["d2g"].append(_dist_to_goal(
                st.pose, _active_waypoint(waypoints, st.wpt_idx)))
            st = _tick(cfg, course, model, waypoints, st, extra_cost, table)
        tel = {name: torch.stack(rows) for name, rows in tel.items()}
        if on_chunk is not None:
            on_chunk(st, tel)
        if bool(st.done) or int(st.ticks) >= course.max_ticks:
            return st
