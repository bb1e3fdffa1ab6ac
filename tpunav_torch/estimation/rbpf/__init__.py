"""Rao-Blackwellized particle-filter grid SLAM
(counterpart: ``tpunav/estimation/rbpf/__init__.py``)."""

from .grid import GridConfig, integrate_scan, likelihood_field_log, occupancy_grid  # noqa: F401
from .icp import icp_match  # noqa: F401
from .particle_filter import PFConfig, PFState, pf_init, pf_slam_step, best_particle  # noqa: F401
