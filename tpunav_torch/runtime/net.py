"""Network transport for the node graph: Channel semantics over TCP.

Copy of ``tpunav/runtime/net.py`` (sockets, threads and pickle; no
accelerator code), with two repairs. :meth:`BusServer.close` shuts each
accepted connection down before closing it, and the accept loop closes a
connection it takes after ``close()``: in ``tpunav`` the close alone does
not wake the server thread blocked in ``recv`` on that socket, so no FIN
is sent and the client's receiver never sees EOF. And a frame's length is
capped at :data:`MAX_FRAME_BYTES`: ``tpunav`` reads a frame of any length
its header claims and unpickles it. A frame over the cap raises
:class:`FrameTooLarge` where it would be sent, and where it would be
received, before its payload is read; the server then drops that
connection. And a publisher's seq is the broker's: ``tpunav``'s
:meth:`NetChannel.publish` stamps ``seq + 1`` locally while the broker
stamps each topic's seq itself, so with two publishers on a topic a
client that advertises without subscribing kept a seq behind the
broker's, and a consumer whose cursor came from remote messages saw that
client's fresh publishes as stale. Here the broker answers each publish
with an ``("ack", topic, seq)`` frame carrying the seq it stamped, and
``publish`` returns once the channel holds it (acks come back in the
order of a connection's publishes, so the late ack of a publish that
timed out is matched to that publish and dropped). With one publisher per
topic the seqs are those ``tpunav`` stamps. Payloads must
be numpy arrays and Python values, never tensors on a card: a process
without one could not unpickle them.

The reference runs its L4 node graph as separate OS processes — on
separate MACHINES for the real robot — wired by ROS topics over TCPROS
(ref: nuturtle_robot/launch/basic_remote.launch:1-40 runs
{serial_node + turtle_interface} on the turtlebot and everything else on
the laptop; every subscription is queue_size=1). The in-process
:class:`~tpunav_torch.runtime.channels.Channel` graph covers the
single-machine case; this module is the cross-process leg (SURVEY.md
§2.7 L1: "a thin host message bus replacing ROS topics ... cross-host
via DCN"):

- :class:`BusServer` — a minimal broker (the roscore analog): clients
  publish (topic, payload) frames; the server stamps a per-topic
  sequence number, keeps only the LATEST value (queue-size-1, exactly
  the reference's latest-wins subscriptions), and forwards to current
  subscribers. Late subscribers immediately receive the latest value
  (ROS latched-topic behavior — needed so a node graph can start in any
  order, like roslaunch's unordered node bringup).
- :class:`BusClient` — one TCP connection + a receiver thread;
  ``advertise()``/``subscribe()`` return :class:`NetChannel` objects
  with the exact ``publish/latest/take_new/seq`` API of the in-process
  Channel, so every node class in runtime/nodes.py and
  runtime/slam_nodes.py runs unmodified across processes.

Wire format: length-prefixed pickle frames (localhost/trusted-LAN
transport, like TCPROS itself — not an authentication boundary). The
NUMERICAL payloads are plain numpy arrays; the hot math never crosses
the bus, only poses/scans/commands do — the same division of labor as
the reference (ROS messages between nodes, Eigen inside them).

Determinism: sequence numbers are stamped by the server per topic, so
``take_new`` across processes has the same "is it fresh" semantics as
in-process. Lockstep (used by the parity test and available to
deployments that want sim-time) is layered ON TOP via
:func:`wait_for_new` — a consumer blocks until a topic's seq advances,
which makes a 2-process pipeline execute in exactly the single-process
tick order.
"""

from __future__ import annotations

import collections
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

_HDR = struct.Struct("!I")
# Far above any frame the node graphs send (a 360-beam scan pickles to
# ~1.6 KB, an 80×80 float32 map to ~26 KB).
MAX_FRAME_BYTES = 64 << 20
# How long a publish waits for the broker's seq before it raises.
ACK_TIMEOUT_S = 30.0


class FrameTooLarge(ConnectionError):
    """A frame longer than the bus's cap."""


def _check_length(n: int) -> None:
    if n > MAX_FRAME_BYTES:
        raise FrameTooLarge(f"a {n}-byte frame exceeds the bus's "
                            f"{MAX_FRAME_BYTES}-byte cap")


def _send_frame(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    _check_length(len(data))
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    _check_length(n)
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return pickle.loads(data)


def _shut(sock: socket.socket) -> None:
    """Shut ``sock`` down, then close it. The shutdown wakes a thread
    blocked in ``accept`` or ``recv`` on it and sends the peer its EOF; a
    close alone does neither while that thread holds the socket."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass                       # not connected, or already shut down
    try:
        sock.close()
    except OSError:
        pass


class _Outbox:
    """Per-connection latest-wins send queue + its own sender thread.

    Forwarding goes through here rather than a direct ``sendall`` so a
    slow/stalled subscriber (e.g. a peer sitting in a multi-second jit
    compile with a full TCP buffer) can never stall the broker or any
    other client: the handler thread just overwrites the topic's slot
    and moves on. Dropping intermediate values per topic IS the
    queue-size-1 contract — the subscriber always ends on the latest.
    """

    def __init__(self, conn: socket.socket):
        self._conn = conn
        self._cond = threading.Condition()
        self._slots: Dict[str, Tuple[int, Any]] = {}    # topic → (seq, val)
        self._acks: collections.deque = collections.deque()  # (topic, seq)
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def offer(self, topic: str, seq: int, val) -> None:
        with self._cond:
            if self._closed:
                return
            cur = self._slots.get(topic)
            if cur is None or seq > cur[0]:       # monotonic per topic
                self._slots[topic] = (seq, val)
                self._cond.notify()

    def ack(self, topic: str, seq: int) -> None:
        """Queue the seq the broker stamped on this connection's publish;
        acks are never coalesced: each publish waits for its own."""
        with self._cond:
            if self._closed:
                return
            self._acks.append((topic, seq))
            self._cond.notify()

    def _drain(self):
        while True:
            with self._cond:
                while (not self._slots and not self._acks
                       and not self._closed):
                    self._cond.wait()
                if self._closed:
                    return
                if self._acks:
                    frame = ("ack", *self._acks.popleft())
                else:
                    topic, (seq, val) = next(iter(self._slots.items()))
                    del self._slots[topic]
                    frame = ("msg", topic, seq, val)
            try:
                _send_frame(self._conn, frame)
            except Exception:      # OSError, pickle errors, MemoryError…
                self.close()       # mark dead → broker prunes on publish
                return

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify()

    @property
    def closed(self) -> bool:
        return self._closed


class BusServer:
    """Minimal latest-wins topic broker. ``port=0`` picks a free port
    (read it back from ``.port`` — the tests do)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.host, self.port = self._srv.getsockname()[:2]
        self._lock = threading.Lock()
        self._latest: Dict[str, Tuple[int, Any]] = {}   # topic → (seq, val)
        self._subs: Dict[str, list] = {}                # topic → [_Outbox]
        self._conns: set = set()
        self._threads = []
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                # close() takes the same lock to stop and to list the
                # connections it closes, so a connection accepted after it
                # is closed here and its client sees EOF.
                if not self._running:
                    _shut(conn)
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _client_loop(self, conn: socket.socket):
        outbox = _Outbox(conn)
        try:
            while self._running:
                try:
                    msg = _recv_frame(conn)
                except OSError:        # FrameTooLarge included
                    break
                if msg is None:
                    break
                kind = msg[0]
                if kind == "sub":
                    topic = msg[1]
                    # Registration + latched enqueue happen under the
                    # lock and delivery rides the same per-conn outbox
                    # as forwards. The outbox slot is monotonic only
                    # while occupied, so the WIRE may still reorder
                    # across a drain; end-to-end ordering is completed
                    # by NetChannel._on_message's seq guard. Duplicate
                    # subscribes from one connection register once
                    # (two nodes in a process sharing a topic).
                    with self._lock:
                        subs = self._subs.setdefault(topic, [])
                        if outbox not in subs:
                            subs.append(outbox)
                        latched = self._latest.get(topic)
                        if latched is not None:
                            outbox.offer(topic, *latched)
                elif kind == "pub":
                    topic, payload = msg[1], msg[2]
                    with self._lock:
                        seq = self._latest.get(topic, (0, None))[0] + 1
                        self._latest[topic] = (seq, payload)
                        lst = self._subs.get(topic)
                        if lst is not None:
                            lst[:] = [ob for ob in lst if not ob.closed]
                            subs = list(lst)
                        else:
                            subs = []
                    for ob in subs:
                        ob.offer(topic, seq, payload)
                    outbox.ack(topic, seq)
        finally:
            with self._lock:
                for subs in self._subs.values():
                    subs[:] = [ob for ob in subs if ob is not outbox]
                self._conns.discard(conn)
            outbox.close()
            conn.close()

    def close(self):
        with self._lock:
            self._running = False
            conns = list(self._conns)
        _shut(self._srv)
        # Close accepted connections too: unblocks their recv loops so
        # handler + outbox threads tear down instead of lingering.
        for c in conns:
            _shut(c)


class NetChannel:
    """Channel API over the bus: publish sends to the broker; the
    client's receiver thread fills (value, seq) for subscriptions.
    ``seq`` is broker-stamped, for the channel's own publishes too (the
    broker's ack), so take_new freshness is globally consistent across
    processes and publishers.

    ``_state`` updates are single tuple assignments (atomic under the
    GIL) and MONOTONIC in seq on both the publish and receive paths, so
    a publish racing the receiver thread (a channel both advertised and
    subscribed) can only move seq forward — take_new never reports stale
    data as fresh."""

    def __init__(self, client: "BusClient", name: str):
        self.name = name
        self._client = client
        self._state: Tuple[int, Any] = (0, None)   # atomic swap under GIL
        self._state_lock = threading.Lock()
        self._pub_lock = threading.Lock()
        # The broker acks a connection's publishes in the order it got them,
        # so the k-th ack of this topic answers this channel's k-th publish:
        # (k, seq), or None once the connection is gone.
        self._acks: "queue.Queue[Optional[Tuple[int, int]]]" = queue.Queue()
        self._sent = 0      # publishes sent (under _pub_lock)
        self._acked = 0     # acks received (the receiver thread's)

    def publish(self, value) -> None:
        # One publish of this channel at a time, so the broker's acks come
        # back in the order of the sends; the wait for the ack holds only
        # _pub_lock, never the lock the receiver thread takes. The late ack
        # of a publish that timed out is dropped here, not taken as this
        # publish's seq.
        with self._pub_lock:
            self._client._publish(self.name, value)
            self._sent += 1
            if not self._client._receiving:
                raise ConnectionError("the bus connection is closed")
            deadline = time.monotonic() + ACK_TIMEOUT_S
            while True:
                try:
                    ack = self._acks.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(
                        f"no seq from the broker for '{self.name}' after "
                        f"{ACK_TIMEOUT_S} s") from None
                if ack is None:
                    raise ConnectionError(f"the bus closed before "
                                          f"'{self.name}''s publish was "
                                          "stamped")
                if ack[0] == self._sent:
                    break
            self._on_message(ack[1], value)

    def _on_message(self, seq: int, payload) -> None:
        with self._state_lock:
            cur, _ = self._state
            if seq > cur:
                self._state = (seq, payload)

    @property
    def seq(self) -> int:
        return self._state[0]

    def latest(self):
        return self._state[1]

    def take_new(self, last_seen: int):
        seq, value = self._state
        if seq > last_seen:
            return value, seq
        return None, last_seen


class BusClient:
    """One process's connection to the bus."""

    def __init__(self, host: str, port: int, retry_s: float = 5.0):
        deadline = time.monotonic() + retry_s
        while True:
            try:
                self._sock = socket.create_connection((host, port))
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._channels: Dict[str, NetChannel] = {}
        self._receiving = True
        self._recv_thread = threading.Thread(target=self._recv_loop,
                                             daemon=True)
        self._recv_thread.start()

    def _publish(self, topic: str, value) -> None:
        with self._send_lock:
            _send_frame(self._sock, ("pub", topic, value))

    def _recv_loop(self):
        try:
            self._receive()
        finally:
            # No ack will come: wake the publishes waiting for one.
            self._receiving = False
            for ch in list(self._channels.values()):
                ch._acks.put(None)

    def _receive(self):
        while True:
            try:
                msg = _recv_frame(self._sock)
            except OSError:
                return
            if msg is None:
                return
            if msg[0] == "msg":
                _, topic, seq, payload = msg
                ch = self._channels.get(topic)
                if ch is not None:
                    ch._on_message(seq, payload)
            elif msg[0] == "ack":
                _, topic, seq = msg
                ch = self._channels[topic]
                ch._acked += 1
                ch._acks.put((ch._acked, seq))

    def advertise(self, topic: str) -> NetChannel:
        ch = self._channels.setdefault(topic, NetChannel(self, topic))
        return ch

    def subscribe(self, topic: str) -> NetChannel:
        ch = self._channels.setdefault(topic, NetChannel(self, topic))
        with self._send_lock:
            _send_frame(self._sock, ("sub", topic))
        return ch

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def wait_for_new(channel, last_seen: int, timeout: float = 10.0,
                 poll_s: float = 0.0002):
    """Block until ``channel.seq > last_seen``; returns (value, seq).
    The lockstep primitive: a consumer process waits on the producer's
    topic instead of free-running, which pins the cross-process tick
    order to the single-process one (the parity test's mechanism).
    Raises TimeoutError on expiry."""
    deadline = time.monotonic() + timeout
    while True:
        value, seq = channel.take_new(last_seen)
        if seq > last_seen:
            return value, seq
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no message on '{channel.name}' after {timeout}s")
        time.sleep(poll_s)
