"""Rectangle-course test controllers (turtlesim harness equivalent).

Port of ``tpunav/sim/tsim.py``. A re-design of the reference's tsim package
(ref: tsim/src/turtle_rect_node.cpp, tsim/config/turtle_params.yaml):
a bang-bang state machine and an open-loop timed feed-forward controller
driving a rectangle course, each publishing PoseError against the plant.
The turtlesim plant is replaced by the diff-drive feedforward model.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import capture
from ..core import diff_drive as dd
from ..core import waypoints as wp
from ..device import DEFAULT_DEVICE
from ..runtime.channels import Channel
from ..runtime.metrics import Metrics, PoseError
from ..runtime.nodes import host


@dataclasses.dataclass(frozen=True)
class TurtleRectConfig:
    """(ref: tsim/config/turtle_params.yaml.)"""

    x: float = 3.0
    y: float = 2.0
    width: float = 4.0
    height: float = 5.0
    trans_vel: float = 2.0
    rot_vel: float = 1.0
    frequency: float = 100.0
    h_tol: float = 0.15
    p_tol: float = 0.15


class TurtleRectBangBang:
    """Turn-then-drive state machine around the rectangle
    (ref: Control::bangBang turtle_rect_node.cpp:217-314)."""

    def __init__(self, cfg: TurtleRectConfig, pose_in: Channel,
                 cmd_vel: Channel, metrics: Metrics | None = None):
        self.cfg = cfg
        self.pose_in = pose_in
        self.cmd_vel = cmd_vel
        self.metrics = metrics or Metrics()
        c = cfg
        self.waypoints = [(c.x, c.y), (c.x + c.width, c.y),
                          (c.x + c.width, c.y + c.height),
                          (c.x, c.y + c.height)]
        self.ctr = 1                      # start toward the second corner
        self.laps = 0

    def reset(self):
        """(ref: traj_reset service.)"""
        self.ctr = 1
        self.laps = 0

    def tick(self, t: float) -> None:
        pose = self.pose_in.latest()      # [theta, x, y]
        if pose is None:
            return
        th, x, y = float(pose[0]), float(pose[1]), float(pose[2])
        gx, gy = self.waypoints[self.ctr]
        bearing = np.arctan2(gy - y, gx - x)
        # The reference compares bearing − theta raw (:240-247) because
        # turtlesim reports theta pre-wrapped to [-pi, pi]; our plant's
        # heading is unwrapped, so wrap the error explicitly.
        h_err = float(np.arctan2(np.sin(bearing - th),
                                 np.cos(bearing - th)))

        self.metrics.record("x_error", abs(x - gx))
        self.metrics.record("y_error", abs(y - gy))
        self.metrics.record("theta_error", abs(h_err))

        if abs(h_err) < self.cfg.h_tol:
            cmd = np.asarray([0.0, self.cfg.trans_vel, 0.0])
        else:
            # Wrap to [0, 2pi) and pick turn direction (ref: :268-277).
            if h_err < 0:
                h_err += 2 * np.pi
            w = self.cfg.rot_vel if h_err <= np.pi else -self.cfg.rot_vel
            cmd = np.asarray([w, 0.0, 0.0])
        self.cmd_vel.publish(cmd)

        if np.hypot(gx - x, gy - y) < self.cfg.p_tol:
            self.ctr += 1
            if self.ctr > 3:
                self.ctr = 0
                self.laps += 1


class TurtleRectFeedForward:
    """Open-loop timed rectangle: drive width, turn 90°, drive height,
    turn, ... (ref: Control::FeedForward turtle_rect_node.cpp:317-…)."""

    def __init__(self, cfg: TurtleRectConfig, cmd_vel: Channel):
        self.cfg = cfg
        self.cmd_vel = cmd_vel
        h_t = cfg.width / cfg.trans_vel
        v_t = cfg.height / cfg.trans_vel
        turn_t = (np.pi / 2) / cfg.rot_vel
        # (duration, twist) segments for one lap.
        self.segments = [
            (h_t, np.asarray([0.0, cfg.trans_vel, 0.0])),
            (turn_t, np.asarray([cfg.rot_vel, 0.0, 0.0])),
            (v_t, np.asarray([0.0, cfg.trans_vel, 0.0])),
            (turn_t, np.asarray([cfg.rot_vel, 0.0, 0.0])),
            (h_t, np.asarray([0.0, cfg.trans_vel, 0.0])),
            (turn_t, np.asarray([cfg.rot_vel, 0.0, 0.0])),
            (v_t, np.asarray([0.0, cfg.trans_vel, 0.0])),
            (turn_t, np.asarray([cfg.rot_vel, 0.0, 0.0])),
        ]
        self.lap_time = sum(s[0] for s in self.segments)

    def tick(self, t: float) -> None:
        phase = t % self.lap_time
        for dur, twist in self.segments:
            if phase < dur:
                self.cmd_vel.publish(twist)
                return
            phase -= dur


class TurtleWay:
    """Pentagon waypoint follower with an internal feedforward model
    (ref: tsim/src/turtle_way_node.cpp:152-193): drives the plant via the
    ``Waypoints`` bang-bang law computed on an internal ``DiffDrive``
    model, and publishes PoseError = |model − plant| each tick — the
    reference's model-vs-turtlesim drift experiment. The model and the
    law's state live in static tensors on ``device`` (default the CUDA
    card); a tick is one ``capture.Graph`` step (``tpunav``'s jitted
    ``_tick``) that writes [cmd, model pose, cycle complete] to one buffer,
    which comes back in one host copy."""

    def __init__(self, waypoints, rot_vel: float, trans_vel: float,
                 frequency: float, pose_in: Channel, cmd_vel: Channel,
                 metrics: Metrics | None = None, device=DEFAULT_DEVICE):
        self.metrics = metrics or Metrics()
        self.pose_in = pose_in
        self.cmd_vel = cmd_vel
        self.scale = 1.0 / frequency
        params = self.params = wp.make_params(
            np.asarray(waypoints, np.float32), rot_vel, trans_vel,
            device=device)
        # One tensor per field (init_state shares one zero among the
        # encoders): the graph writes each in place.
        wstate = self.wstate = wp.WaypointState(
            *(t.clone() for t in wp.init_state(device=device)))
        model = self.model = dd.DiffDriveState(*(t.clone() for t in
                                                 dd.init_state(
            0.0, float(waypoints[0][0]), float(waypoints[0][1]),
            device=device)))
        out = self._out = torch.zeros(7, device=model.pose.device)
        scale = self.scale
        self._done = False

        def body():
            cmd, ws = wp.next_waypoint(params, wstate, dd.pose(model))
            nxt = dd.feedforward(dd.TURTLEBOT3, model, cmd * scale)
            capture.load(wstate, ws)
            capture.load(model, nxt)
            torch.cat([cmd, dd.pose(nxt), ws.cycle_complete.reshape(1).to(
                out.dtype)], out=out)

        self._graph = capture.Graph(body, device)

    def tick(self, t: float) -> None:
        self._graph()
        out = host(self._out)
        self._done = bool(out[6])
        self.cmd_vel.publish(np.asarray(out[:3], float))
        plant_pose = self.pose_in.latest()
        if plant_pose is not None:
            err = PoseError.between(np.asarray(out[3:6], float),
                                    np.asarray(plant_pose))
            self.metrics.record("x_error", abs(err.x_error))
            self.metrics.record("y_error", abs(err.y_error))
            self.metrics.record("theta_error", abs(err.theta_error))

    @property
    def done(self) -> bool:
        """The pentagon cycle is complete, as of the last tick's copy."""
        return self._done
