"""Typed config dataclasses + YAML loading.

A copy of the loaders in ``tpunav/runtime/config.py`` (that package's
``runtime/__init__`` imports jax, so it cannot be imported here). YAML maps
directly onto the frozen config dataclasses, with the same key names, so
``configs/*.yaml`` load into both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Type, TypeVar

import numpy as np
import yaml

T = TypeVar("T")


# Key aliases: yaml name → dataclass field.
_ALIASES = {
    "lambda": "lambda_",
    "str": "str_",
}


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a (frozen) dataclass from a dict, tolerating extra keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in data.items():
        key = _ALIASES.get(key, key)
        if key in fields:
            if isinstance(val, list):
                val = tuple(val)
            kwargs[key] = val
    return cls(**kwargs)


def load_yaml_config(cls: Type[T], path: str, **overrides) -> T:
    """Load a YAML file into a config dataclass (overrides win)."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    data.update(overrides)
    return from_dict(cls, data)


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """Physical robot constants (schema: configs/diff_params.yaml)."""

    wheel_radius: float = 0.033
    wheel_base: float = 0.160
    wheel_width: float = 0.018
    chassis_length: float = 0.138
    chassis_thickness: float = 0.140
    encoder_ticks_per_rev: int = 4096
    max_trans: float = 0.22
    max_rot: float = 2.84
    max_rot_motor: float = 6.35495
    max_motor_power: int = 265
    wheel_axle_offset: float = 0.02
    max_motor_torque: float = 1.5


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """2D scanner geometry (schema: configs/lds01_lidar.yaml, the
    reference's bmapping/config/LDS_01_lidar.yaml:1-11). Angles in DEGREES
    like the file; the properties give radians and the beam count."""

    beam_min: float = 0.0
    beam_max: float = 360.0
    beam_delta: float = 1.0
    range_min: float = 0.12
    range_max: float = 3.5

    @property
    def num_beams(self) -> int:
        return int(round((self.beam_max - self.beam_min) / self.beam_delta))

    @property
    def beam_min_rad(self) -> float:
        return math.radians(self.beam_min)

    @property
    def beam_delta_rad(self) -> float:
        return math.radians(self.beam_delta)


def load_robot_config(path: str, **overrides) -> RobotConfig:
    return load_yaml_config(RobotConfig, path, **overrides)


def load_lidar_config(path: str, **overrides) -> LidarConfig:
    return load_yaml_config(LidarConfig, path, **overrides)


def load_mppi_config(path: str, **overrides):
    """Load mppi_params.yaml into the port's MPPIConfig. Maps the keys that
    differ from the dataclass fields (time_step→dt, Q/R/P1→*_diag,
    ul_init/ur_init→u_init)."""
    from ..control.mppi import MPPIConfig

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    data.update(overrides)
    remap = {"time_step": "dt", "Q": "q_diag", "R": "r_diag",
             "P1": "p1_diag"}
    for src, dst in remap.items():
        if src in data:
            data[dst] = data.pop(src)
    ul = data.pop("ul_init", None)
    ur = data.pop("ur_init", None)
    if ul is not None or ur is not None:
        data["u_init"] = (float(ul or 0.0), float(ur or 0.0))
    return from_dict(MPPIConfig, data)


def load_waypoints(path: str) -> np.ndarray:
    """Load a waypoint course (schema: configs/real_waypoints.yaml).
    Returns an (n, 3) float array of [x, y, theta] rows."""
    with open(path) as f:
        data = yaml.safe_load(f)
    x = np.asarray(data["x_component"], np.float64)
    y = np.asarray(data["y_component"], np.float64)
    th = np.asarray(data.get("theta_component", np.zeros_like(x)),
                    np.float64)
    return np.stack([x, y, th], axis=-1)
