"""Structured metrics: per-tick records + pose-error tracking.

Copy of ``tpunav/runtime/metrics.py`` (numpy only). Replaces the
reference's PoseError topics + rqt_plot (SURVEY.md §5:
tsim/msg/PoseError.msg, nuslam/src/slam_node.cpp:436-463) and the
commented-out chrono probes with a first-class ring-buffer recorder.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, NamedTuple

import numpy as np


class PoseError(NamedTuple):
    """(ref: tsim/msg/PoseError.msg — x/y/theta error vs ground truth)."""

    x_error: float
    y_error: float
    theta_error: float

    @staticmethod
    def between(est, truth) -> "PoseError":
        """est/truth: (3,) [theta, x, y]."""
        est = np.asarray(est, float)
        truth = np.asarray(truth, float)
        dth = float(np.arctan2(np.sin(est[0] - truth[0]),
                               np.cos(est[0] - truth[0])))
        return PoseError(x_error=float(est[1] - truth[1]),
                         y_error=float(est[2] - truth[2]),
                         theta_error=dth)


class Metrics:
    """Named ring-buffer time series + solve-rate stopwatch."""

    def __init__(self, maxlen: int = 10_000):
        self.series: Dict[str, Deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=maxlen))
        self._t0: Dict[str, float] = {}

    def record(self, name: str, value) -> None:
        self.series[name].append(float(value))

    def start(self, name: str) -> None:
        self._t0[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._t0[name]
        self.record(name + "_ms", dt * 1e3)
        return dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.series.items():
            arr = np.asarray(vals)
            if arr.size:
                out[name] = {
                    "mean": float(arr.mean()),
                    "p50": float(np.percentile(arr, 50)),
                    "p99": float(np.percentile(arr, 99)),
                    "last": float(arr[-1]),
                    "n": int(arr.size),
                }
        return out
