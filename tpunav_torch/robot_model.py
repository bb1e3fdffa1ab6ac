"""Robot description: the framework's URDF equivalent.

Copy of ``tpunav/robot_model.py`` (numpy only). The reference ships the TurtleBot3 Burger model as a xacro URDF
(ref: nuturtle_description/urdf/diff_drive.urdf.xacro) whose every
dimension is pulled from diff_params.yaml and whose inertias are
computed inline from box/cylinder formulas. Without ROS there is no
robot_state_publisher/rviz consumer, so the artifact is a typed LINK TREE
built from the same :class:`RobotConfig` constants with
the same derived quantities:

- link poses (chassis, wheels, caster, lidar mount) use the xacro joint
  origins verbatim (diff_drive.urdf.xacro:143-180);
- masses/inertias use the same box/cylinder closed forms
  (diff_drive.urdf.xacro:33-37, 66-69) with the xacro's M=0.94 kg
  chassis / m=0.03 kg wheels;
- :func:`footprint` gives the 2D collision footprint the planners use
  (the projection of the chassis box + wheels), and
  :func:`tpunav_torch.viz.draw_robot` renders it — the rviz RobotModel
  replacement.

Consumers: sim/plant.py (mass/inertia for motor dynamics live in
sim/motor.py's torque caps), planning (footprint radius for clearance),
viz (demo overlays).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .runtime.config import RobotConfig


@dataclasses.dataclass(frozen=True)
class Link:
    """One rigid body of the model: pose offset in base_body frame,
    geometry, mass, and the diagonal of its inertia tensor."""

    name: str
    origin_xyz: Tuple[float, float, float]
    geometry: str                  # "box" | "cylinder" | "sphere"
    size: Tuple[float, ...]        # box: (l, w, t); cyl: (r, len); sph: (r,)
    mass: float = 0.0
    inertia_diag: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """The full link tree (fixed + wheel joints flattened to offsets)."""

    links: Dict[str, Link]
    config: RobotConfig

    @property
    def caster_radius(self) -> float:
        c = self.config
        return (c.wheel_radius - c.wheel_axle_offset) / 2.0

    def footprint(self) -> np.ndarray:
        """(N, 2) CCW polygon of the robot's 2D collision footprint in
        the base frame: the chassis box plus wheel extents — what the
        planners inflate obstacles by."""
        c = self.config
        # Base joint shifts base_body by -wheel_radius and the chassis
        # visual sits at chassis_length/2 - wheel_radius within it
        # (xacro :145, :41): chassis spans [-2wr, cl-2wr] in base_link,
        # wheels (centered at x=-wr) span [-2wr, 0].
        x0 = -2.0 * c.wheel_radius                  # chassis/wheel rear
        x1 = c.chassis_length - 2.0 * c.wheel_radius  # chassis front
        xw = 0.0                                    # wheel front extent
        half_w = (c.wheel_base + c.wheel_width) / 2.0   # over the wheels
        cw2 = (c.wheel_base - c.wheel_width) / 2.0      # chassis half-width
        return np.asarray([
            [x0, -half_w], [xw, -half_w], [x1, -cw2],
            [x1, cw2], [xw, half_w], [x0, half_w],
        ])

    def bounding_radius(self) -> float:
        """Max distance of any footprint vertex from base_link — the
        clearance radius for the planners."""
        return float(np.max(np.linalg.norm(self.footprint(), axis=1)))


def _box_inertia(m, l, w, t):
    """(diff_drive.urdf.xacro:35-37.)"""
    return (m / 12.0 * (l * l + t * t),
            m / 12.0 * (w * w + t * t),
            m / 12.0 * (l * l + w * w))


def _cylinder_inertia(m, r, length):
    """(diff_drive.urdf.xacro:66-69 — axis along the cylinder.)"""
    side = m / 12.0 * (3.0 * r * r + length * length)
    return (side, side, 0.5 * m * r * r)


CHASSIS_MASS = 0.94   # kg (diff_drive.urdf.xacro:18)
WHEEL_MASS = 0.03     # kg (diff_drive.urdf.xacro:20)


def build_model(cfg: RobotConfig = RobotConfig()) -> RobotModel:
    """Assemble the link tree from the diff_params constants, mirroring
    the xacro joint origins (diff_drive.urdf.xacro:143-180)."""
    wr, wb = cfg.wheel_radius, cfg.wheel_base
    cl, ct, ww = cfg.chassis_length, cfg.chassis_thickness, cfg.wheel_width
    axle = cfg.wheel_axle_offset
    caster_r = (wr - axle) / 2.0
    chassis_w = wb - ww      # box width between the wheels (xacro :42)

    base_z = ct / 2.0 - axle + wr   # base joint z (xacro :145)
    links = {
        "base_body": Link(
            # x: base joint (-wr, xacro :145) + visual offset (cl/2 - wr,
            # xacro :41) = cl/2 - 2wr in base_link.
            "base_body", (cl / 2.0 - 2.0 * wr, 0.0, base_z),
            "box", (cl, chassis_w, ct), CHASSIS_MASS,
            _box_inertia(CHASSIS_MASS, cl, chassis_w, ct)),
        "left_wheel": Link(
            "left_wheel", (-wr, wb / 2.0, base_z - ct / 2.0 + axle),
            "cylinder", (wr, ww), WHEEL_MASS,
            _cylinder_inertia(WHEEL_MASS, wr, ww)),
        "right_wheel": Link(
            "right_wheel", (-wr, -wb / 2.0, base_z - ct / 2.0 + axle),
            "cylinder", (wr, ww), WHEEL_MASS,
            _cylinder_inertia(WHEEL_MASS, wr, ww)),
        "caster": Link(
            "caster",
            (-wr + cl - wr - caster_r, 0.0, base_z - ct / 2.0 - caster_r),
            "sphere", (caster_r,)),
        "base_scan": Link(
            "base_scan", (-wr, 0.0, base_z + ct / 2.0 + 0.005),
            "cylinder", (0.035, 0.02)),   # LDS-01 puck, visual only
    }
    return RobotModel(links=links, config=cfg)


TURTLEBOT3_MODEL = build_model()
