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

import importlib

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
from .checkpoint import load_pytree, save_pytree  # noqa: F401
from .metrics import Metrics, PoseError  # noqa: F401
from .profiling import (SolveProfiler, enable, phase, span,  # noqa: F401
                        summary, trace)

# The nodes import the filters and loops, which import the tracer from
# here: loaded on first use, so importing a filter first is no cycle.
_LAZY = ("nodes", "slam_nodes", "distributed")


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
