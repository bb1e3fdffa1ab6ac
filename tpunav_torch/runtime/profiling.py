"""Tracing and profiling: the port's one tracer, Chrome traces, and a
per-solve timer.

Port of ``tpunav/runtime/profiling.py``. The reference's only timing
instrumentation is a commented-out std::chrono probe around the MPPI solve
(ref: nuturtle_robot/src/mppi_waypoints_node.cpp:260-273 — the source of
its 50 Hz claim; SURVEY.md §5). Here profiling is built in:

- :func:`trace` wraps ``torch.profiler.profile`` and writes a Chrome trace
  (host operations and, where CUDA is available, device kernels) into
  ``log_dir``, viewable in Perfetto or ``chrome://tracing``.
- The tracer times the program's replayed steps without the profiler. It
  is off by default and switched for the whole process by :func:`enable`.
  Off, :func:`span` and :func:`phase` return one shared no-op context and
  a ``capture.Graph`` runs as it would without it; a graph captured while
  it is off holds no node of it. On:

  - :func:`span` records a host region: its name, its start and end on
    ``time.perf_counter_ns``, its step (the step number of the graph it
    serves: the spans of one step share it) and its parent span, in a
    bounded ring, with each name's count and sum beside it. Under an
    active ``torch.profiler`` it enters ``record_function`` instead and
    records nothing, so the region sits in the profiler's trace beside the
    launches it caused and the store holds only what the profiler did not
    slow.
  - Each replay of a ``capture.Graph`` on the card is timed on the device
    by two timing events around its launch, from a ring of :data:`PAIRS`
    event pairs, each read with ``query()`` once complete: the tracer
    never synchronizes, and the host waits only where every pair is still
    in flight. An anchor (an event recorded on an idle stream, with the
    host clock read beside it) maps the events onto the spans' clock, so
    :func:`idle_by_span` can put each gap between replays down to the
    host span that overlapped it most (``host:caller`` where none did).
  - :func:`phase` times a region of a graph's step on the device: two
    external timing events captured into the graph, read just before its
    next launch. A replay whose pair has not completed by then is counted
    as missed, never waited for.
  - On the CPU a graph's step and its phases are timed on the host clock.

  :func:`summary` gives the aggregates; replays and phases taken under the
  profiler are kept apart from them.
- :class:`SolveProfiler` wraps any solve callable in a span that
  synchronizes the device of its result for honest device timing, and
  reports Hz / p50 / p99 via the Metrics summary.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from .metrics import Metrics

# The switch, read by span(), phase() and capture.Graph on every call.
ON = False

SPANS = 65_536        # records each ring holds
PAIRS = 64            # timing-event pairs in flight per device
ANCHOR_NS = 50_000_000  # an idle stream re-anchors the clock at most this often

_NOOP = contextlib.nullcontext()


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


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


# ── arithmetic on intervals (nanoseconds) ──

def to_host_ns(anchor_ns: int, anchor_to_event_ms: float) -> int:
    """An event's time on the host clock: the anchor's host time plus the
    device's elapsed time from the anchor event to the event."""
    return anchor_ns + round(anchor_to_event_ms * 1e6)


def attribute(gaps, spans) -> Dict[str, float]:
    """Milliseconds of ``gaps`` ((start, end) on the host clock) by host
    span: each gap whole to the span with the most of its own time inside
    it (its overlap less its children's), ``host:caller`` where no span
    overlaps it. ``spans`` are records (seq, name, start, end, step,
    parent)."""
    spans = sorted(spans, key=lambda s: s[2])
    out: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for a, b in sorted(gaps):
        while j < len(spans) and spans[j][3] < a:
            j += 1
        own: Dict[int, list] = {}
        for seq, name, s0, s1, _, parent in spans[j:]:
            if s0 > b:
                break
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                own[seq] = [name, ov, parent]
        for _, ov, parent in list(own.values()):
            if parent in own:
                own[parent][1] -= ov
        best = max(own.values(), key=lambda r: r[1], default=None)
        out[best[0] if best is not None and best[1] > 0
            else "host:caller"] += (b - a) * 1e-6
    return dict(out)


# ── the store ──

class _Timeline:
    """Replays of one device, harvested in order: the union of their
    intervals and the gaps between them, over runs of replays taken
    without the profiler (one taken under it ends a run)."""

    def __init__(self):
        self.last_end: Optional[int] = None

    def add(self, st: "_Store", t0: int, t1: int, step: int,
            profiled: bool) -> None:
        st.replays.append((t0, t1, step, profiled))
        if profiled:
            st.counts["profiled"] += 1
            self.last_end = None
            return
        c = st.counts
        c["timed"] += 1
        c["device_ns"] += t1 - t0
        if self.last_end is None:
            c["busy_ns"] += t1 - t0
            c["window_ns"] += t1 - t0
            self.last_end = t1
            return
        if t0 > self.last_end:
            st.gaps.append((self.last_end, t0))
        c["busy_ns"] += max(0, t1 - max(t0, self.last_end))
        c["window_ns"] += max(0, t1 - self.last_end)
        self.last_end = max(self.last_end, t1)


class _Clock(_Timeline):
    """One card's replay timers: the event pairs free and in flight, and
    the anchor that maps their times onto the host clock."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.free = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(PAIRS)]
        self.flight: collections.deque = collections.deque()
        self.anchor = None
        self.anchored_at = 0
        self.stream_id, self.stream = None, None

    def current_stream(self):
        """The device's current stream, rebuilt only where it changed:
        ``torch.cuda.current_stream`` costs microseconds a call."""
        sid = torch._C._cuda_getCurrentStream(self.device.index)[0]
        if sid != self.stream_id:
            self.stream_id = sid
            self.stream = torch.cuda.current_stream(self.device)
        return self.stream

    def reanchor(self, stream) -> None:
        """An anchor on ``stream``, which must be idle (the first one
        waits for it: the one synchronize the tracer makes)."""
        if self.anchor is None:
            stream.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        self.anchor = (ev, time.perf_counter_ns())
        self.anchored_at = self.anchor[1]

    def harvest(self, st: "_Store") -> None:
        while self.flight and self.flight[0][1].query():
            start, end, step, profiled, (ev, ns) = self.flight.popleft()
            t0 = to_host_ns(ns, ev.elapsed_time(start))
            self.add(st, t0, t0 + round(start.elapsed_time(end) * 1e6),
                     step, profiled)
            self.free.append((start, end))

    def take(self, st: "_Store"):
        if not self.free:
            self.flight[0][1].synchronize()
            self.harvest(st)
        return self.free.pop()


class _Store:
    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=SPANS)
        self.span_totals: Dict[str, List[int]] = {}
        self.replays: collections.deque = collections.deque(maxlen=SPANS)
        self.gaps: collections.deque = collections.deque(maxlen=SPANS)
        self.phases: collections.deque = collections.deque(maxlen=SPANS)
        self.phase_totals: Dict[str, list] = {}
        self.counts = collections.Counter()
        self.clocks: Dict[object, _Timeline] = {}
        self.current = None       # the graph whose step runs or is captured
        self.step_t0 = 0          # the host step's start (on the CPU)
        self.seq = 0
        self.local = threading.local()

    def timeline(self, device: torch.device) -> _Timeline:
        key = (device.type, device.index)
        if key not in self.clocks:
            if device.type != "cuda":
                self.clocks[key] = _Timeline()
            else:    # "cuda" alone names the current card
                self.clocks[key] = _Clock(torch.device(
                    "cuda", torch.cuda.current_device()
                    if device.index is None else device.index))
        return self.clocks[key]

    def add_phase(self, name: str, step: int, ms: Optional[float],
                  offset_ms: float, profiled: bool) -> None:
        """A phase's device ms (None: not read in time) and its start's ms
        after its step's start."""
        tot = self.phase_totals.setdefault(name, [0, 0.0, 0, 0.0])
        if ms is None:
            tot[2] += 1
            return
        self.phases.append((name, step, ms, offset_ms, profiled))
        if not profiled:
            tot[0] += 1
            tot[1] += ms
            tot[3] += offset_ms

    def harvest(self) -> None:
        for clock in self.clocks.values():
            if isinstance(clock, _Clock):
                clock.harvest(self)


_store = _Store()


def enable(on: bool) -> None:
    """Switch the tracer for the whole process. On starts a new record;
    off stops recording and leaves the record readable. A graph reads the
    switch when it is captured: one captured while it was off times no
    phase."""
    global ON, _store
    if on:
        _store = _Store()
    ON = bool(on)


# ── host spans ──

def _stack() -> list:
    """This thread's open spans: (seq, name, step, parent seq)."""
    local = _store.local
    if not hasattr(local, "stack"):
        local.stack = []
    return local.stack


def _record(seq: int, name: str, t0: int, t1: int, step: int,
            parent: int) -> None:
    _store.spans.append((seq, name, t0, t1, step, parent))
    tot = _store.span_totals.setdefault(name, [0, 0])
    tot[0] += 1
    tot[1] += t1 - t0


class Span:
    """A timed host region: ``ns`` is its length once it has ended. While
    the tracer is on it is recorded (``step`` from ``graph``, else from its
    parent); under an active profiler it enters ``record_function``
    instead. :func:`span` gives one only where the tracer is on."""

    __slots__ = ("name", "graph", "ns", "_t0", "_rf", "_open")

    def __init__(self, name: str, graph=None):
        self.name, self.graph = name, graph
        self.ns = 0

    def __enter__(self):
        self._rf = self._open = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        elif ON:
            stack = _stack()
            parent = stack[-1] if stack else (0, None, -1)
            # A span inside one of its own name is part of it.
            if parent[1] != self.name:
                _store.seq += 1
                step = (self.graph.steps if self.graph is not None
                        else parent[2])
                self._open = (_store.seq, self.name, step, parent[0])
                stack.append(self._open)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        elif self._open is not None:
            _stack().pop()
            seq, name, step, parent = self._open
            _record(seq, name, self._t0, t1, step, parent)
        return False


def span(name: str, graph=None):
    """A host span named ``name`` (see :class:`Span`), or the shared no-op
    context while the tracer is off. ``graph``: the ``capture.Graph`` whose
    step the region serves."""
    if not ON:
        return _NOOP
    return Span(name, graph)


# ── device phases ──

class _Phase:
    __slots__ = ("name", "graph", "_a", "_t0")

    def __init__(self, name, graph):
        self.name, self.graph = name, graph

    def __enter__(self):
        if self.graph.device.type == "cuda":
            self._a = torch.cuda.Event(enable_timing=True, external=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.graph.device.type == "cuda":
            b = torch.cuda.Event(enable_timing=True, external=True)
            b.record()
            self.graph.phases.append((self.name, self._a, b))
        else:
            _store.add_phase(self.name, self.graph.steps,
                             (time.perf_counter_ns() - self._t0) * 1e-6,
                             (self._t0 - _store.step_t0) * 1e-6,
                             _profiling())
        return False


def phase(name: str):
    """A region of a graph's step timed on the device at every replay (on
    the CPU, on the host clock at every step): only while the tracer is on
    and a ``capture.Graph`` captures or (on the CPU) runs its step;
    otherwise the shared no-op context."""
    if not ON or _store.current is None:
        return _NOOP
    return _Phase(name, _store.current)


# ── what capture.Graph calls while the tracer is on ──

@contextlib.contextmanager
def capturing(graph):
    """``graph``'s capture: the phases inside it are recorded into it
    while the tracer is on."""
    prev, _store.current = _store.current, graph
    try:
        yield
    finally:
        _store.current = prev


def run_on_host(graph, body: Callable[[], None]) -> None:
    """``graph``'s step run eagerly on the CPU, timed on the host clock as
    a replay is timed on the card, its phases with it."""
    profiled = _profiling()
    with capturing(graph):
        t0 = _store.step_t0 = time.perf_counter_ns()
        body()
        t1 = time.perf_counter_ns()
    _store.timeline(graph.device).add(_store, t0, t1, graph.steps, profiled)


def replay(graph, launch: Callable[[], None]) -> None:
    """``launch`` (``graph``'s replay) between two timing events on the
    current stream, as a ``graph.launch`` span. The phases of ``graph``'s
    previous replay are read before it (the launch records them anew); the
    completed pairs after it, while the device runs it. What precedes the
    launch is kept to a minimum: where the host waits on each replay, it
    adds to the step."""
    st = _store
    step, profiled = graph.steps, _profiling()
    if graph.phase_step is not None:
        # The previous replay's pair is still in flight, so its start
        # event is the one that replay recorded.
        prev_step, prev_profiled, prev_start = graph.phase_step
        for name, a, b in graph.phases:
            done = b.query()
            st.add_phase(name, prev_step, a.elapsed_time(b) if done else None,
                         prev_start.elapsed_time(a) if done else 0.0,
                         prev_profiled)
    clock = st.timeline(graph.device)
    stream = clock.current_stream()
    if clock.anchor is None or (
            time.perf_counter_ns() - clock.anchored_at > ANCHOR_NS and
            stream.query()):
        clock.reanchor(stream)
    start, end = clock.take(st)
    start.record(stream)
    if profiled:
        with torch.profiler.record_function("graph.launch"):
            launch()
    else:
        t0 = time.perf_counter_ns()
        launch()
        t1 = time.perf_counter_ns()
    end.record(stream)
    if not profiled:
        stack = _stack()
        st.seq += 1
        _record(st.seq, "graph.launch", t0, t1, step,
                stack[-1][0] if stack else 0)
    clock.flight.append((start, end, step, profiled, clock.anchor))
    graph.phase_step = (step, profiled, start) if graph.phases else None
    clock.harvest(st)


# ── reading ──

def idle_by_span() -> Dict[str, float]:
    """The idle milliseconds between replays taken without the profiler,
    by the host span that overlapped each gap most (:func:`attribute`),
    over the gaps since the oldest span the ring still holds."""
    _store.harvest()
    spans = list(_store.spans)
    since = spans[0][2] if len(spans) == _store.spans.maxlen else None
    return attribute([g for g in _store.gaps
                      if since is None or g[0] >= since], spans)


def records() -> dict:
    """The rings as lists: ``spans`` (seq, name, start ns, end ns, step,
    parent seq: 0 for none), ``replays`` (start ns, end ns, step,
    profiled), ``phases`` (name, step, ms, ms from the step's start to the
    phase's, profiled)."""
    _store.harvest()
    return {"spans": list(_store.spans), "replays": list(_store.replays),
            "phases": list(_store.phases)}


def summary() -> dict:
    """The aggregates of what the tracer took without the profiler, after
    reading every completed replay (it never waits):

    - ``spans``: {name: count, total_ms, mean_us};
    - ``replays``: ``timed``, ``in_flight`` (not yet complete),
      ``profiled`` (taken under the profiler, left out), ``device_ms``
      (mean interval from a replay's start event to its end event),
      ``window_ms`` and ``idle_pct`` (one minus the union of the replays'
      intervals over their span, runs broken by profiled replays);
    - ``phases``: {name: count, missed, mean_ms, offset_ms}: ``offset_ms``
      the mean time from a step's start to the phase's (on the card from
      the event before the launch, so it holds the device's wait for the
      launch where the phase opens the graph);
    - ``idle_by_span``: :func:`idle_by_span`."""
    st = _store
    st.harvest()
    c = st.counts
    n = c["timed"]
    return {
        "spans": {name: {"count": k, "total_ms": ns * 1e-6,
                         "mean_us": ns * 1e-3 / k}
                  for name, (k, ns) in st.span_totals.items()},
        "replays": {
            "timed": n, "profiled": c["profiled"],
            "in_flight": sum(len(k.flight) for k in st.clocks.values()
                             if isinstance(k, _Clock)),
            "device_ms": c["device_ns"] * 1e-6 / n if n else None,
            "window_ms": c["window_ns"] * 1e-6,
            "idle_pct": (100.0 * (1.0 - c["busy_ns"] / c["window_ns"])
                         if c["window_ns"] else None)},
        "phases": {name: {"count": k, "missed": miss,
                          "mean_ms": ms / k if k else None,
                          "offset_ms": off / k if k else None}
                   for name, (k, ms, miss, off) in st.phase_totals.items()},
        "idle_by_span": idle_by_span()}


# ── per-solve timing ──

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
    """Per-call wall-clock profiler around a solve callable: each call is a
    :class:`Span` named ``name`` that waits for its result's device.

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
        with Span(self.name) as s:
            out = self.fn(*args, **kwargs)
            for device in _cuda_devices(out, set()):
                torch.cuda.synchronize(device)
        self.metrics.record(self.name + "_ms", s.ns * 1e-6)
        return out

    def hz(self) -> float:
        """Mean solve rate over the recorded window."""
        s = self.metrics.summary().get(self.name + "_ms")
        return 0.0 if not s else 1e3 / s["mean"]

    def summary(self):
        return self.metrics.summary().get(self.name + "_ms", {})
