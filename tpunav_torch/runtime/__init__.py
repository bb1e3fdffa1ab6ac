"""Host runtime: channels, node scheduler, nodes, the TCP bus, config,
metrics, checkpoints, profiling and the multi-process group (counterpart:
``tpunav/runtime/__init__.py``, without ``cache``, the XLA compile
cache).

Replaces the reference's ROS1 substrate (SURVEY.md §2.7, L1/L4/L5):
roscpp pub/sub topics → in-process latest-wins channels (and
``runtime.net``'s bus across processes); roslaunch/rosparam → typed
config dataclasses + YAML; ros::Rate loops → a deterministic virtual-time
scheduler (or wall-clock); rosbag-less state → state checkpoints.
"""

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
from .channels import Channel, Node, Scheduler  # noqa: F401
from . import nodes  # noqa: F401
from . import slam_nodes  # noqa: F401
from . import distributed  # noqa: F401
from .checkpoint import load_pytree, save_pytree  # noqa: F401
from .metrics import Metrics, PoseError  # noqa: F401
from .profiling import SolveProfiler, annotate, trace  # noqa: F401
