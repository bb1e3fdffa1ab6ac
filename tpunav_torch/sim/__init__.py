"""Simulation models used inside the closed loop
(counterpart: ``tpunav/sim/__init__.py``)."""

from .motor import MotorParams, track  # noqa: F401
