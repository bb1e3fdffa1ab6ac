"""Simulation models used inside the closed loop: wheel motors, the
landmark sensor and the lidar (counterpart: ``tpunav/sim/__init__.py``)."""

from .landmark_sensor import (  # noqa: F401
    associate_known,
    landmark_measurements,
)
from .lidar import box_segments, scan_cylinders, scan_segments  # noqa: F401
from .motor import MotorParams, track  # noqa: F401
