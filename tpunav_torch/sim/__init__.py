"""Simulation models used inside the closed loop: wheel motors, the
landmark sensor and the lidar (counterpart: ``tpunav/sim/__init__.py``).
The host sims of the node graph are the modules ``sim.plant`` (the
diff-drive plant) and ``sim.tsim`` (the rectangle and pentagon course
controllers)."""

from .landmark_sensor import (  # noqa: F401
    associate_known,
    landmark_measurements,
)
from .lidar import box_segments, scan_cylinders, scan_segments  # noqa: F401
from .motor import MotorParams, track  # noqa: F401
