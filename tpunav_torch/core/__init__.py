"""Core math: angle wrapping and SE(2) on batched tensors
(counterpart: ``tpunav/core/__init__.py``)."""
