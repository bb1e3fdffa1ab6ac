"""Simulation models used inside the closed loop
(counterpart: ``tpunav/sim/__init__.py``)."""

from .lidar import box_segments, scan_cylinders, scan_segments  # noqa: F401
from .motor import MotorParams, track  # noqa: F401
