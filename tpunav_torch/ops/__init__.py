"""Batched device math: RK4, Philox, the bearing polynomial, the EDT and
the kernels K1–K4 (counterpart: ``tpunav/ops/__init__.py``)."""

from .rk4 import rk4_solve, rk4_step  # noqa: F401
