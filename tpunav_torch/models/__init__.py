"""Robot models (counterpart: ``tpunav/models/__init__.py``)."""

from .cart import CartParams, kinematic_cart  # noqa: F401
