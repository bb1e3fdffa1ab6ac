"""Batched device math: RK4, Philox and the fused MPPI solve
(counterpart: ``tpunav/ops/__init__.py``)."""

from .rk4 import rk4_solve, rk4_step  # noqa: F401
