"""CUDA graphs of the port's loops: the counterpart of ``jax.jit`` over
``tpunav``'s ``while_loop`` and ``scan``.

No counterpart module in ``tpunav``: there a course, a chunk of ticks or an
RBPF update is one compiled device program because XLA traces it. The port
runs eagerly, one host dispatch per operation, so its loops are bound by
the host (``PERF.md`` §5). A :class:`Graph` takes a step body that reads
and writes static tensors in place and, on the card, records it once as a
CUDA graph that each later step replays with one launch.

- The first call on the card runs the body eagerly on a side stream: it is
  the warm-up (libraries create their handles, the kernels' library loads)
  and also the first real step. The second call captures the body into a
  graph with a private memory pool and replays it; later calls replay.
- On the CPU, which the caller must ask for, every call runs the body on
  the same static tensors without capture, so the CPU tests exercise the
  buffer logic that the card replays.
- A capture or replay error raises: there is no return to the eager path.
- Randomness: the bodies of this package draw nothing themselves. Their
  callers draw a step's normals eagerly from the state's
  ``torch.Generator`` into static tensors before each replay (the
  ``noise=`` seams), with the calls and shapes of the eager step, so the
  graph sees the eager path's bits. K1's in-kernel Philox is keyed by a
  device int32 seed and needs nothing.
- Launch counters: the kernel wrappers count launches in Python, so a
  replay would not move them. Capture records each counter's change during
  the capture, takes it back (nothing ran), and adds it on every replay.
- A graph reads its static tensors where they lay at capture: a state that
  a graph replays is loaded into them in place (:func:`load`), never
  rebound.
"""

from __future__ import annotations

import gc
import importlib
from typing import Callable, Dict

import torch

from .device import DEFAULT_DEVICE, resolve
from .runtime import profiling

# Each kernel's launch counter: (module of tpunav_torch.ops, attribute).
COUNTERS = {"K1": ("fused_mppi", "KERNEL_LAUNCHES"),
            "K1_obstacle": ("fused_mppi", "OBSTACLE_LAUNCHES"),
            "K2": ("likelihood", "LIK_LAUNCHES"),
            "K3": ("map_update", "MAP_LAUNCHES"),
            "K4": ("map_update", "EDT_LAUNCHES"),
            "EIG": ("sym_eig", "EIG_LAUNCHES")}


def _module(name: str):
    # Imported at call time: ops.fused_mppi imports control/, whose loops
    # import this module.
    return importlib.import_module(f"{__package__}.ops.{name}")


def read_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by the names of :data:`COUNTERS`."""
    return {key: getattr(_module(mod), attr)
            for key, (mod, attr) in COUNTERS.items()}


def add_counts(deltas: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``deltas`` to the kernels' launch counters."""
    for key, delta in deltas.items():
        mod, attr = COUNTERS[key]
        m = _module(mod)
        setattr(m, attr, getattr(m, attr) + times * delta)


def counted(fn: Callable[[], None]) -> Dict[str, int]:
    """Run ``fn`` and return each counter's change, with the counters set
    back to where they were: what a capture records, since a captured
    launch does not run."""
    before = read_counts()
    fn()
    after = read_counts()
    deltas = {key: after[key] - before[key] for key in before}
    add_counts(deltas, -1)
    return deltas


def load(buffers, values) -> None:
    """Copy ``values`` into ``buffers`` in place, field by field (two tuples
    of one layout, such as a step's state and the state a step computed).
    A ``torch.Generator`` field takes the other's state, unless it is that
    generator: so a body may load the state it computed, which carries the
    generator it shares."""
    for buf, val in zip(buffers, values, strict=True):
        if isinstance(buf, torch.Generator):
            if buf is not val:
                buf.set_state(val.get_state())
        else:
            buf.copy_(val)


def state_device(t: torch.Tensor, device=DEFAULT_DEVICE) -> torch.device:
    """The device of a stepper built on ``t``: ``device`` (resolved, so a
    CUDA default raises without CUDA) with ``t``'s index; raises unless
    ``t`` lies there."""
    dev = resolve(device)
    if t.device.type != dev.type or dev.index not in (None, t.device.index):
        raise ValueError(f"the state lies on {t.device}, not on {dev}")
    return t.device


class Graph:
    """``body`` (a function of no arguments that reads and writes static
    tensors on ``device``) as one step, replayed from a CUDA graph on the
    card; ``device`` defaults to the card and raises without CUDA.

    ``deltas`` holds the launch counters' change per replay, ``replays``
    the replays so far, ``steps`` the steps run (the warm-up and the CPU's
    included: the tracer's step id). While ``runtime.profiling``'s tracer
    is on, each replay is timed on the device and its launch is a
    ``graph.launch`` span; ``phases`` holds the device phases captured
    into the graph. ``error_mode`` is the capture's
    ``cudaStreamCaptureMode``. The default ``"global"`` prohibits
    potentially unsafe CUDA calls in every thread while a capture runs;
    ProcessGroupNCCL's watchdog thread queries its collectives' events
    all along, so a body with NCCL collectives passes ``"thread_local"``,
    which holds the capturing thread alone to that rule."""

    def __init__(self, body: Callable[[], None], device=DEFAULT_DEVICE,
                 error_mode: str = "global"):
        self.device = resolve(device)
        self._body = body
        self._error_mode = error_mode
        self._warm = False
        self._graph = None
        self.deltas: Dict[str, int] = {}
        self.replays = 0
        self.steps = 0
        self.phases = []
        self.phase_step = None

    def __call__(self) -> None:
        """Run one step."""
        if self.device.type != "cuda":
            if profiling.ON:
                profiling.run_on_host(self, self._body)
            else:
                self._body()
        elif not self._warm:
            self._warm_up()
        else:
            if self._graph is None:
                self._capture()
            if profiling.ON:
                profiling.replay(self, self._graph.replay)
            else:
                self._graph.replay()
            add_counts(self.deltas)
            self.replays += 1
        self.steps += 1

    def _warm_up(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body()
        main.wait_stream(side)
        self._warm = True

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()

        def record():
            with torch.cuda.graph(graph,
                                  capture_error_mode=self._error_mode):
                with profiling.capturing(self):
                    self._body()

        # Any CUDA call that is illegal during a capture, in any thread,
        # invalidates it; the cyclic collector dropping an earlier graph
        # frees that graph's memory pool. Collect first, then hold it off.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                self.deltas = counted(record)
        finally:
            if collecting:
                gc.enable()
        self._graph = graph
