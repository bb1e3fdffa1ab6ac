"""Differential-drive kinematics as plain functions over a NamedTuple state.

Port of ``tpunav/core/diff_drive.py`` (the reference's ``rigid2d::DiffDrive``,
rigid2d/include/rigid2d/diff_drive.hpp:37-104,
rigid2d/src/rigid2d/diff_drive.cpp). State is an immutable
``DiffDriveState`` and every method is a function
``(params, state, ...) -> new_state`` over tensors with any leading batch
dimensions (a fleet or a particle axis), keeping the reference's quirks:

- ``update_odometry`` wraps encoder *deltas* and stored encoder angles to
  [-pi, pi) (diff_drive.cpp:97-150);
- ``feedforward`` wraps the wheel *velocities* through normalize_angle_PI
  (diff_drive.cpp:153-195), which the feedforward/updateOdometry
  consistency invariant of rigid2d/test/test_diff_drive.cpp:391-475 needs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import DEFAULT_DEVICE, resolve
from . import se2
from .angles import normalize_angle_pi


class DiffDriveParams(NamedTuple):
    """Fixed geometry (configs/diff_params.yaml — TurtleBot3 Burger)."""

    wheel_radius: float  # 0.033 m
    wheel_base: float    # 0.160 m


# Canonical robot constants (configs/diff_params.yaml).
TURTLEBOT3 = DiffDriveParams(wheel_radius=0.033, wheel_base=0.160)
MAX_TRANS_VEL = 0.22       # m/s
MAX_ROT_VEL = 2.84         # rad/s
MAX_WHEEL_VEL = 6.35495    # rad/s (max_rot_motor)
MAX_MOTOR_POWER = 265      # integer command full-scale
ENCODER_TICKS_PER_REV = 4096


class DiffDriveState(NamedTuple):
    """Robot pose + encoder state. All leaves share leading batch dims."""

    pose: torch.Tensor   # (..., 3) [theta, x, y]
    left: torch.Tensor   # left wheel encoder angle (rad)
    right: torch.Tensor  # right wheel encoder angle (rad)
    ul: torch.Tensor     # last left wheel velocity (rad / time-unit)
    ur: torch.Tensor     # last right wheel velocity


def init_state(theta=0.0, x=0.0, y=0.0, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> DiffDriveState:
    """A robot at (theta, x, y) with zeroed encoders, on ``device``
    (default the CUDA card; raises without CUDA unless ``device="cpu"``)."""
    f = dict(dtype=dtype, device=resolve(device))
    z = torch.zeros((), **f)
    return DiffDriveState(
        pose=se2.make(torch.as_tensor(theta, **f), torch.as_tensor(x, **f),
                      torch.as_tensor(y, **f)),
        left=z, right=z, ul=z, ur=z)


def twist_to_wheels(params: DiffDriveParams, twist):
    """Body twist [w, vx, vy] → wheel velocities (ul, ur)
    (ref: DiffDrive::twistToWheels diff_drive.cpp:56-76; vy is ignored,
    which equals the reference for the vy = 0 it accepts)."""
    d = params.wheel_base / 2.0
    w, vx = twist[..., 0], twist[..., 1]
    ul = (-d * w + vx) / params.wheel_radius
    ur = (d * w + vx) / params.wheel_radius
    return torch.stack([ul, ur], dim=-1)


def wheels_to_twist(params: DiffDriveParams, wheel_vel):
    """Wheel velocities (ul, ur) → body twist [w, vx, 0]
    (ref: DiffDrive::wheelsToTwist diff_drive.cpp:79-94)."""
    ul, ur = wheel_vel[..., 0], wheel_vel[..., 1]
    w = params.wheel_radius / params.wheel_base * (ur - ul)
    vx = params.wheel_radius * 0.5 * (ul + ur)
    return torch.stack([w, vx, torch.zeros_like(vx)], dim=-1)


def _wrap_heading(pose):
    return torch.cat([normalize_angle_pi(pose[..., :1]), pose[..., 1:]],
                     dim=-1)


def _like(v, ref):
    """``v`` on ``ref``'s device and dtype. A host number is copied without
    waiting for the device's queue: ``torch.as_tensor(v, device=cuda)``
    would block, and the runtime's nodes call this on every message."""
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=ref.dtype)
    return torch.as_tensor(v, dtype=ref.dtype).to(ref.device,
                                                  non_blocking=True)


def update_odometry(params: DiffDriveParams, state: DiffDriveState,
                    left, right):
    """Advance the pose from new absolute encoder angles. Returns
    (new_state, wheel_vel), wheel_vel the wrapped encoder delta
    (ref: DiffDrive::updateOdometry diff_drive.cpp:97-150)."""
    left = _like(left, state.left)
    right = _like(right, state.right)
    dul = normalize_angle_pi(left - state.left)
    dur = normalize_angle_pi(right - state.right)
    wheel_vel = torch.stack([dul, dur], dim=-1)
    pose = _wrap_heading(se2.integrate_twist(state.pose,
                                             wheels_to_twist(params,
                                                             wheel_vel)))
    return DiffDriveState(pose=pose, left=normalize_angle_pi(left),
                          right=normalize_angle_pi(right), ul=dul,
                          ur=dur), wheel_vel


def feedforward(params: DiffDriveParams, state: DiffDriveState, cmd):
    """Propagate a commanded body twist for one time-unit, advancing the
    simulated encoders (ref: DiffDrive::feedforward diff_drive.cpp:153-195).
    ``cmd`` is [w, vx, vy=0] already scaled by the caller's dt."""
    wheel_vel = twist_to_wheels(params, cmd)
    ul, ur = wheel_vel[..., 0], wheel_vel[..., 1]
    return DiffDriveState(
        pose=_wrap_heading(se2.integrate_twist(state.pose, cmd)),
        left=normalize_angle_pi(state.left + ul),
        right=normalize_angle_pi(state.right + ur),
        ul=normalize_angle_pi(ul), ur=normalize_angle_pi(ur))


def pose(state: DiffDriveState):
    """Current pose with wrapped heading (ref: DiffDrive::pose
    diff_drive.cpp:198-206)."""
    return _wrap_heading(state.pose)


def reset(state: DiffDriveState, theta, x, y) -> DiffDriveState:
    """Reset the pose and keep the encoders (ref: DiffDrive::reset
    diff_drive.cpp:221-234, which deliberately does not clear them)."""
    f = dict(dtype=state.pose.dtype, device=state.pose.device)
    return state._replace(pose=se2.make(torch.as_tensor(theta, **f),
                                        torch.as_tensor(x, **f),
                                        torch.as_tensor(y, **f)))
