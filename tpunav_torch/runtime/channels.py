"""Latest-wins channels + cooperative node scheduler.

Copy of ``tpunav/runtime/channels.py`` (it has no accelerator code). The
replacement for the reference's ROS1 node graph: every
subscription in the reference uses queue_size=1 (latest-wins, e.g.
rigid2d/src/odometry_node.cpp:110-113), and each node is a single-threaded
``ros::spinOnce`` loop at a fixed rate. Here:

- :class:`Channel` is a single-slot mailbox (publish overwrites; read
  peeks) — the exact queue-size-1 semantics, without serialization since
  payloads are numpy arrays handed between stages.
- :class:`Node` owns a tick rate and a ``tick(t)`` callback.
- :class:`Scheduler` steps all nodes in deterministic virtual time
  (reproducible sim runs, no wall-clock jitter), or in wall-clock mode
  for real-robot loops.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Callable, List, Optional


class Channel:
    """Single-slot latest-wins mailbox (ROS queue_size=1 equivalent)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value: Any = None
        self._seq = 0

    def publish(self, value) -> None:
        self._value = value
        self._seq += 1

    @property
    def seq(self) -> int:
        return self._seq

    def latest(self):
        """Peek the most recent value (None if never published)."""
        return self._value

    def take_new(self, last_seen: int):
        """Return (value, seq) if newer than ``last_seen`` else (None,
        last_seen) — the 'message flag' pattern every reference node uses
        (e.g. turtle_interface_node.cpp twist_message/sensor_message)."""
        if self._seq > last_seen:
            return self._value, self._seq
        return None, last_seen


class Node:
    """A rate-driven callback, mirroring one reference ROS node."""

    def __init__(self, name: str, rate_hz: float,
                 tick: Callable[[float], None]):
        self.name = name
        self.period = 1.0 / rate_hz
        self.tick = tick
        self.next_t = 0.0

    def __repr__(self):
        return f"Node({self.name}, {1.0 / self.period:.0f} Hz)"


class Scheduler:
    """Deterministic virtual-time executor for a set of nodes.

    Nodes fire in timestamp order (ties broken by registration order) —
    the single-machine analogue of the reference's multi-process launch
    graph, minus the nondeterministic socket interleaving.
    """

    def __init__(self, realtime: bool = False):
        self.nodes: List[Node] = []
        self.realtime = realtime
        self.t = 0.0

    def add(self, node: Node) -> Node:
        node.next_t = self.t
        self.nodes.append(node)
        return node

    def run(self, duration: float,
            until: Optional[Callable[[], bool]] = None) -> float:
        """Advance virtual time by ``duration`` seconds (or until the
        predicate fires). Returns the final virtual time."""
        heap = [(n.next_t, i, n) for i, n in enumerate(self.nodes)]
        heapq.heapify(heap)
        end = self.t + duration
        wall_start = time.monotonic() - self.t
        while heap:
            t_next, i, node = heapq.heappop(heap)
            if t_next > end:
                heapq.heappush(heap, (t_next, i, node))
                break
            self.t = t_next
            if self.realtime:
                lag = self.t - (time.monotonic() - wall_start)
                if lag > 0:
                    time.sleep(lag)
            node.tick(self.t)
            node.next_t = t_next + node.period
            heapq.heappush(heap, (node.next_t, i, node))
            if until is not None and until():
                # Early break: virtual time stays at the tick that
                # satisfied the predicate, not up to a full ``duration``
                # later.
                return self.t
        self.t = end
        return self.t
