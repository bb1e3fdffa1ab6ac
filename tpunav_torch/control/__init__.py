"""Sampling-based MPC (MPPI), the obstacle cost fields, the waypoint
course and the SLAM-in-the-loop course
(counterpart: ``tpunav/control/__init__.py``)."""

from .mppi import MPPIConfig, MPPIController, init_controls, mppi_solve  # noqa: F401
from .slam_loop import (  # noqa: F401
    SlamLoopConfig,
    SlamLoopState,
    run_slam_loop,
    slam_loop_init,
    slam_loop_tick,
)
