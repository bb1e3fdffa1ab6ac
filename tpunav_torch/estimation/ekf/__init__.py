"""EKF SLAM over cylindrical landmarks
(counterpart: ``tpunav/estimation/ekf/__init__.py``)."""

from .filter import (  # noqa: F401
    EKFConfig,
    EKFState,
    ekf_init,
    known_correspondence_slam,
    landmark_map,
    robot_pose,
    slam_unknown_da,
)
from .spd import is_spd, nearest_spd  # noqa: F401
