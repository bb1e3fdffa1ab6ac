"""Simulated robot plant: integer wheel commands → encoder ticks.

Copy of ``tpunav/sim/plant.py`` (numpy only; the robot constants come from
the port's ``core/diff_drive.py``). A re-design of the Gazebo
TurtleDrivePlugin
(ref: nuturtle_gazebo/src/turtle_drive_plugin.cpp): wheel commands scale
to joint velocities by max_motor_rot_vel/max_motor_power (:226-232); at
the sensor rate (default 200 Hz, :140-152) joint positions advance and
are published as integer encoder ticks. The plant also integrates the
true pose so closed-loop error metrics have ground truth.
"""

from __future__ import annotations

import numpy as np

from ..core import diff_drive as dd
from ..runtime.channels import Channel
from .motor import MotorParams


class DiffDrivePlant:
    def __init__(self, params: dd.DiffDriveParams, wheel_cmd: Channel,
                 sensor: Channel, sensor_rate_hz: float = 200.0,
                 max_motor_rot_vel: float = dd.MAX_WHEEL_VEL,
                 max_motor_power: int = dd.MAX_MOTOR_POWER,
                 ticks_per_rev: int = dd.ENCODER_TICKS_PER_REV,
                 motor: MotorParams | None = None):
        self.params = params
        self.wheel_cmd = wheel_cmd
        self.sensor = sensor
        self.dt = 1.0 / sensor_rate_hz
        self.vel_scale = max_motor_rot_vel / max_motor_power
        self.ticks_per_rad = ticks_per_rev / (2.0 * np.pi)
        self.left = 0.0                  # wheel angles (rad, unwrapped)
        self.right = 0.0
        self.pose = np.zeros(3)          # ground truth [theta, x, y]
        self._seen = 0
        self._ul = 0.0                   # commanded wheel velocities
        self._ur = 0.0
        # Motor dynamics (ref: the Gazebo engine ramps joints toward the
        # velocity target under max_motor_torque,
        # turtle_drive_plugin.cpp:226-232). None/τ=0 = ideal tracking.
        self.motor = motor or MotorParams()
        self._wl = 0.0                   # actual wheel velocities
        self._wr = 0.0

    def tick(self, t: float) -> None:
        cmd, self._seen = self.wheel_cmd.take_new(self._seen)
        if cmd is not None:
            self._ul = float(cmd[0]) * self.vel_scale
            self._ur = float(cmd[1]) * self.vel_scale

        if self.motor.time_const > 0.0:
            import math
            alpha = 1.0 - math.exp(-self.dt / self.motor.time_const)
            lim = self.motor.max_accel * self.dt
            self._wl += max(-lim, min(lim, alpha * (self._ul - self._wl)))
            self._wr += max(-lim, min(lim, alpha * (self._ur - self._wr)))
        else:
            self._wl, self._wr = self._ul, self._ur

        dl = self._wl * self.dt
        dr = self._wr * self.dt
        self.left += dl
        self.right += dr
        # True pose: exact diff-drive integration of the wheel increment.
        r, b = self.params.wheel_radius, self.params.wheel_base
        w = r / b * (dr - dl)
        vx = r * 0.5 * (dl + dr)
        th = self.pose[0]
        if abs(w) < 1e-12:
            self.pose = self.pose + np.asarray(
                [0.0, vx * np.cos(th), vx * np.sin(th)])
        else:
            self.pose = self.pose + np.asarray(
                [w, (vx / w) * (np.sin(th + w) - np.sin(th)),
                 (vx / w) * (np.cos(th) - np.cos(th + w))])

        self.sensor.publish((int(round(self.left * self.ticks_per_rad)),
                             int(round(self.right * self.ticks_per_rad))))
