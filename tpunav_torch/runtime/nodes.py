"""Prebuilt runtime nodes mirroring the reference's L4 process graph.

Port of ``tpunav/runtime/nodes.py``. Each class re-creates one reference
ROS node as a channel-driven tick callback (SURVEY.md §2.1/§2.6).
Payloads stay numpy, as in ``tpunav``, so a message can cross the TCP bus
(``runtime/net.py``) to a process without a card. A node that holds
diff-drive state keeps it on ``device`` (default the CUDA card; raises
without CUDA unless ``device="cpu"``): a message that enters it is copied
to the device once, without waiting for the device's queue, and what it
publishes comes back in one copy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import diff_drive as dd
from ..core.angles import normalize_angle_pi
from ..device import DEFAULT_DEVICE
from .channels import Channel


def to_device(values, dtype, device) -> torch.Tensor:
    """A message's numbers as one tensor on ``device``: one copy from a host
    tensor, which does not wait for the device's queue."""
    return torch.tensor(np.asarray(values), dtype=dtype).to(
        device, non_blocking=True)


def to_static(buf: torch.Tensor, values) -> None:
    """A message's numbers into a graph's static tensor ``buf`` in one
    copy, which does not wait for the device's queue."""
    buf.copy_(torch.tensor(np.asarray(values), dtype=buf.dtype),
              non_blocking=True)


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, the payload type of every channel: a copy, also
    of a CPU tensor, so a payload never aliases a graph's static output."""
    return t.detach().to("cpu", copy=True).numpy()


class OdometerNode:
    """joint_states → odometry pose (ref: rigid2d/src/odometry_node.cpp:
    169-253, incl. the set_pose reset service :46-64)."""

    def __init__(self, params: dd.DiffDriveParams, joints: Channel,
                 odom: Channel, device=DEFAULT_DEVICE):
        self.params = params
        self.joints = joints
        self.odom = odom
        self.state = dd.init_state(device=device)
        self._seen = 0

    def set_pose(self, theta, x, y) -> bool:
        """(ref: set_pose.srv + setPoseService.)"""
        self.state = dd.reset(self.state, theta, x, y)
        self.odom.publish(host(dd.pose(self.state)))
        return True

    def tick(self, t: float) -> None:
        msg, self._seen = self.joints.take_new(self._seen)
        if msg is None:
            return
        # (pos_l, pos_r[, vel_l, vel_r])
        lr = to_device(msg[:2], self.state.left.dtype, self.state.left.device)
        self.state, _ = dd.update_odometry(self.params, self.state, lr[0],
                                           lr[1])
        self.odom.publish(host(dd.pose(self.state)))


class FakeDiffEncodersNode:
    """cmd_vel → simulated encoder joint_states (ref:
    rigid2d/src/fake_diff_encoders_node.cpp:100-144 — the twist is scaled
    by 1/rate before feedforward, :107-110)."""

    def __init__(self, params: dd.DiffDriveParams, cmd_vel: Channel,
                 joints: Channel, rate_hz: float = 60.0,
                 device=DEFAULT_DEVICE):
        self.params = params
        self.cmd_vel = cmd_vel
        self.joints = joints
        self.scale = 1.0 / rate_hz
        self.state = dd.init_state(device=device)
        self._seen = 0

    def tick(self, t: float) -> None:
        msg, self._seen = self.cmd_vel.take_new(self._seen)
        if msg is None:
            return
        cmd = to_device(msg, self.state.left.dtype,
                        self.state.left.device) * self.scale
        self.state = dd.feedforward(self.params, self.state, cmd)
        left, right = host(torch.stack([self.state.left,
                                        self.state.right])).tolist()
        self.joints.publish((left, right))


class TurtleInterfaceNode:
    """Hardware abstraction (ref: nuturtle_robot/src/
    turtle_interface_node.cpp:135-206): cmd_vel → clamped twist → wheel
    velocities → clamped → integer WheelCommands; SensorData encoder
    ticks → wheel angles → JointState.

    The twist → wheel conversion and the tick → angle conversion are a few
    multiply-adds on host numbers, done on the host in float64 as the
    reference does in double; the odometry state stays on ``device``."""

    def __init__(self, params: dd.DiffDriveParams, cmd_vel: Channel,
                 wheel_cmd: Channel, sensor: Channel, joints: Channel,
                 max_trans: float = dd.MAX_TRANS_VEL,
                 max_rot: float = dd.MAX_ROT_VEL,
                 max_rot_motor: float = dd.MAX_WHEEL_VEL,
                 max_motor_power: int = dd.MAX_MOTOR_POWER,
                 encoder_ticks_per_rev: int = dd.ENCODER_TICKS_PER_REV,
                 device=DEFAULT_DEVICE):
        self.params = params
        self.cmd_vel = cmd_vel
        self.wheel_cmd = wheel_cmd
        self.sensor = sensor
        self.joints = joints
        self.max_trans = max_trans
        self.max_rot = max_rot
        self.max_rot_motor = max_rot_motor
        self.power_scale = max_motor_power / max_rot_motor
        self.rad_per_tick = 2.0 * np.pi / encoder_ticks_per_rev
        self.state = dd.init_state(device=device)
        self._seen_cmd = 0
        self._seen_sensor = 0

    def tick(self, t: float) -> None:
        cmd, self._seen_cmd = self.cmd_vel.take_new(self._seen_cmd)
        if cmd is not None:
            w = float(np.clip(cmd[0], -self.max_rot, self.max_rot))
            vx = float(np.clip(cmd[1], -self.max_trans, self.max_trans))
            wv = dd.twist_to_wheels(self.params, torch.tensor(
                [w, vx, 0.0], dtype=torch.float64)).numpy()
            ul = float(np.clip(wv[0], -self.max_rot_motor,
                               self.max_rot_motor))
            ur = float(np.clip(wv[1], -self.max_rot_motor,
                               self.max_rot_motor))
            self.wheel_cmd.publish((int(round(self.power_scale * ul)),
                                    int(round(self.power_scale * ur))))

        ticks, self._seen_sensor = self.sensor.take_new(self._seen_sensor)
        if ticks is not None:
            dtype = self.state.left.dtype
            angles = normalize_angle_pi(torch.tensor(
                [self.rad_per_tick * ticks[0], self.rad_per_tick * ticks[1]],
                dtype=torch.float64)).to(dtype)
            lr = angles.to(self.state.left.device, non_blocking=True)
            self.state, wheel_vel = dd.update_odometry(
                self.params, self.state, lr[0], lr[1])
            # JointState carries positions AND encoder-derived velocities
            # (ref: turtle_interface_node.cpp:169-206; the rostest asserts
            # both, turtle_interface_test_node.cpp:227-231).
            left, right = angles.tolist()
            vl, vr = host(wheel_vel).tolist()
            self.joints.publish((left, right, vl, vr))


class WaypointDriverNode:
    """Waypoint-cycling controller scaffold shared by the MPPI and
    P-control drivers (ref: mppi_waypoints_node.cpp:226-305 and
    real_waypoint_node.cpp:236-258): on each new odometry pose, check the
    distance-to-goal, advance cyclically (one full cycle then stop), and
    emit cmd_vel from the supplied control law. It holds no device state:
    the law decides where it computes, and returns a numpy twist."""

    def __init__(self, odom: Channel, cmd_vel: Channel,
                 waypoints: Sequence[Sequence[float]],
                 control_law, goal_thresh: float = 0.1):
        self.odom = odom
        self.cmd_vel = cmd_vel
        self.waypoints = [np.asarray(w, float) for w in waypoints]
        self.control_law = control_law   # (pose_xyt, wpt) -> twist (3,)
        self.goal_thresh = goal_thresh
        self.idx = 0
        self.ctr = 0
        self.done = False
        self._seen = 0
        self.started = False

    def start(self) -> None:
        """(ref: start service :329-359.)"""
        self.started = True

    def stop(self) -> None:
        """(ref: stop service :362-368.)"""
        self.started = False
        self.cmd_vel.publish(np.zeros(3))

    def tick(self, t: float) -> None:
        pose, self._seen = self.odom.take_new(self._seen)
        if pose is None or not self.started or self.done:
            return
        pose = np.asarray(pose, float)     # [theta, x, y]
        wpt = self.waypoints[self.idx]
        d = float(np.hypot(wpt[0] - pose[1], wpt[1] - pose[2]))
        if d < self.goal_thresh:
            self.idx = (self.idx + 1) % len(self.waypoints)
            self.ctr += 1
            if self.ctr == len(self.waypoints) + 1:
                self.done = True           # one full cycle (ref: :231-258)
                self.stop()
                return
            wpt = self.waypoints[self.idx]
        pose_xyt = np.asarray([pose[1], pose[2], pose[0]])
        self.cmd_vel.publish(np.asarray(self.control_law(pose_xyt, wpt)))


class RotationNode:
    """Calibration maneuvers (ref: nuturtle_robot/src/rotation_node.cpp:
    166-348): timer-driven cmd_vel performing either 20 full rotations
    with 1/20-revolution pauses between each, or — when ``direction`` is
    "forward"/"backward" — 10 translation steps of 0.2 m with pauses of
    1/10 the step time (the reference's one service selects the mode,
    rotation_node.cpp:225-249)."""

    def __init__(self, cmd_vel: Channel, direction: str = "clockwise",
                 frac_vel: float = 0.5, num_cycles: Optional[int] = None,
                 max_rot: float = dd.MAX_ROT_VEL,
                 max_trans: float = dd.MAX_TRANS_VEL,
                 step_dist: float = 0.2):
        self.cmd_vel = cmd_vel
        if direction in ("clockwise", "counter-clockwise"):
            self.mode = "rotation"
            sign = -1.0 if direction == "clockwise" else 1.0
            self.w = sign * frac_vel * max_rot
            self.v = 0.0
            self.num_cycles = 20 if num_cycles is None else num_cycles
            # one revolution, then pause 1/20 of a revolution
            self.cycle_time = 2.0 * np.pi / abs(self.w)
            self.pause_time = self.cycle_time / 20.0
        elif direction in ("forward", "backward"):
            self.mode = "translation"
            sign = 1.0 if direction == "forward" else -1.0
            self.w = 0.0
            self.v = sign * frac_vel * max_trans
            self.num_cycles = 10 if num_cycles is None else num_cycles
            # one 0.2 m step, then pause 1/10 of the step time
            # (ref: rotation_node.cpp:299-312)
            self.cycle_time = step_dist / abs(self.v)
            self.pause_time = self.cycle_time / 10.0
        else:
            raise ValueError(f"not a valid direction: {direction!r}")
        self.done = False

    def tick(self, t: float) -> None:
        if self.done:
            self.cmd_vel.publish(np.zeros(3))
            return
        slot = t // (self.cycle_time + self.pause_time)
        if slot >= self.num_cycles:
            self.done = True
            self.cmd_vel.publish(np.zeros(3))
            return
        phase = t - slot * (self.cycle_time + self.pause_time)
        if phase < self.cycle_time:
            self.cmd_vel.publish(np.asarray([self.w, self.v, 0.0]))
        else:
            self.cmd_vel.publish(np.zeros(3))
