"""Core math: angle wrapping, SE(2), diff-drive kinematics, waypoint
controllers and random draws on tensors
(counterpart: ``tpunav/core/__init__.py``)."""

from . import angles, diff_drive, randoms, se2, waypoints  # noqa: F401
from .angles import (  # noqa: F401
    almost_equal,
    deg2rad,
    normalize_angle_2pi,
    normalize_angle_pi,
    rad2deg,
)
from .diff_drive import (  # noqa: F401
    TURTLEBOT3,
    DiffDriveParams,
    DiffDriveState,
)
