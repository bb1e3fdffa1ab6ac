"""Sampling-based MPC (MPPI), the obstacle cost fields and the waypoint
course (counterpart: ``tpunav/control/__init__.py``)."""

from .mppi import MPPIConfig, MPPIController, init_controls, mppi_solve  # noqa: F401
