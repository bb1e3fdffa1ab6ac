"""State estimation: EKF SLAM (nuslam) and RBPF grid SLAM (bmapping)
(counterpart: ``tpunav/estimation/__init__.py``)."""
