"""Host runtime: configuration loaders
(counterpart: ``tpunav/runtime/__init__.py``)."""

from .config import (  # noqa: F401
    LidarConfig,
    RobotConfig,
    load_landmarks,
    load_lidar_config,
    load_mppi_config,
    load_robot_config,
    load_waypoints,
    load_world,
    load_yaml_config,
    save_yaml_config,
)
