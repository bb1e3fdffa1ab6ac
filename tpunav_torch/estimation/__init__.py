"""State estimation: RBPF grid SLAM (bmapping)
(counterpart: ``tpunav/estimation/__init__.py``)."""
