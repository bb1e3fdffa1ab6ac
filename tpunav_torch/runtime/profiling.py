"""Tracing / profiling: device traces + per-solve timing as first-class.

Port of ``tpunav/runtime/profiling.py``. The reference's only timing
instrumentation is a commented-out std::chrono probe around the MPPI solve
(ref: nuturtle_robot/src/mppi_waypoints_node.cpp:260-273 — the source of
its 50 Hz claim; SURVEY.md §5). Here profiling is built in:

- :func:`trace` wraps ``torch.profiler.profile`` and writes a Chrome trace
  (host operations and, where CUDA is available, device kernels) into
  ``log_dir``, viewable in Perfetto or ``chrome://tracing``.
- :func:`annotate` labels host-side regions inside a trace.
- :class:`SolveProfiler` wraps any solve callable with a ring-buffer
  wall-clock timer (synchronizing the device of its result for honest
  device timing) and reports Hz / p50 / p99 via the Metrics summary.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Callable, Optional

import torch

from .metrics import Metrics


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace into ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}."
                 f"{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named host-side region inside an active trace."""
    return torch.profiler.record_function(name)


def _cuda_devices(out, found):
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for sub in out:
            _cuda_devices(sub, found)
    elif isinstance(out, dict):
        for sub in out.values():
            _cuda_devices(sub, found)
    return found


class SolveProfiler:
    """Per-call wall-clock profiler around a solve callable.

    >>> prof = SolveProfiler(solve_fn, name="mppi")
    >>> out = prof(*args)          # timed: waits for the result's device
    >>> prof.hz(), prof.summary()  # rate + percentiles
    """

    def __init__(self, fn: Callable, name: str = "solve",
                 metrics: Optional[Metrics] = None, maxlen: int = 10_000):
        self.fn = fn
        self.name = name
        self.metrics = metrics if metrics is not None else Metrics(maxlen)

    def __call__(self, *args, **kwargs):
        self.metrics.start(self.name)
        out = self.fn(*args, **kwargs)
        for device in _cuda_devices(out, set()):
            torch.cuda.synchronize(device)
        self.metrics.stop(self.name)
        return out

    def hz(self) -> float:
        """Mean solve rate over the recorded window."""
        s = self.metrics.summary().get(self.name + "_ms")
        return 0.0 if not s else 1e3 / s["mean"]

    def summary(self):
        return self.metrics.summary().get(self.name + "_ms", {})
