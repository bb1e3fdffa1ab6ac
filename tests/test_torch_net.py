"""The port's TCP bus (``runtime/net.py``, a copy of ``tpunav``'s with the
accept-loop repair and a frame-length cap) and the node graph across two
OS processes.

The two-process graph is ``examples_torch.full_stack_two_process``, the
counterpart of examples/full_stack_two_process.py, run here on the CPU: the robot
(plant, turtle_interface, odometer, landmark sensor) in one process and
the laptop (PRM + Theta*, EKF SLAM, the MPPI driver through K1's plain
version at K=128) in another, lockstep over the bus, against the same
graph in one process. The waypoint node's MPPI law is one ``capture.Graph``
step, held bit for bit to its eager form.
"""

import socket
import time

import numpy as np
import pytest

from examples_torch import full_stack_two_process as fstp
from tpunav_torch.runtime import net
from tpunav_torch.runtime.net import BusClient, BusServer, wait_for_new


def test_bus_latest_wins_and_latched():
    srv = BusServer()
    try:
        a = BusClient(srv.host, srv.port)
        b = BusClient(srv.host, srv.port)
        pub, sub = a.advertise("t"), b.subscribe("t")
        pub.publish(np.array([1.0]))
        pub.publish(np.array([2.0]))
        val, seq = wait_for_new(sub, 1, timeout=5)
        assert seq == 2
        np.testing.assert_array_equal(val, [2.0])
        v, s = sub.take_new(seq)
        assert v is None and s == seq
        # A late subscriber receives the latest value at once.
        c = BusClient(srv.host, srv.port)
        val, seq = wait_for_new(c.subscribe("t"), 0, timeout=5)
        assert seq == 2
        np.testing.assert_array_equal(val, [2.0])
        for cl in (a, b, c):
            cl.close()
    finally:
        srv.close()


def test_bus_payloads_are_arrays_and_tuples():
    srv = BusServer()
    try:
        a = BusClient(srv.host, srv.port)
        b = BusClient(srv.host, srv.port)
        sub, pub = b.subscribe("mixed"), a.advertise("mixed")
        payload = (np.arange(6.0).reshape(2, 3), (3, 4), "joints",
                   np.array([1, -1], np.int8))
        pub.publish(payload)
        val, _ = wait_for_new(sub, 0, timeout=5)
        np.testing.assert_array_equal(val[0], payload[0])
        assert val[1] == (3, 4) and val[2] == "joints"
        assert val[3].dtype == np.int8
        a.close()
        b.close()
    finally:
        srv.close()


def test_bus_burst_coalesces_to_latest():
    """A fast burst coalesces in the per-connection outbox: the subscriber
    converges on the final value and seq."""
    srv = BusServer()
    try:
        a = BusClient(srv.host, srv.port)
        b = BusClient(srv.host, srv.port)
        sub, pub = b.subscribe("burst"), a.advertise("burst")
        n = 500
        for i in range(n):
            pub.publish(np.array([float(i)]))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and sub.seq < n:
            time.sleep(0.002)
        assert sub.seq == n
        np.testing.assert_array_equal(sub.latest(), [float(n - 1)])
        a.close()
        b.close()
    finally:
        srv.close()


def test_bus_server_close_unblocks_clients():
    """close() closes the accepted connections. One publish → wait_for_new
    round trip first, so the server has registered the connection."""
    srv = BusServer()
    a = BusClient(srv.host, srv.port)
    b = BusClient(srv.host, srv.port)
    sub = a.subscribe("t")
    b.advertise("t").publish(np.zeros(1))
    wait_for_new(sub, 0, timeout=5)      # forwarded to a: a is registered
    srv.close()
    for cl in (a, b):
        cl._recv_thread.join(timeout=5.0)
        assert not cl._recv_thread.is_alive()
        cl.close()


def test_bus_connection_accepted_after_close_is_closed():
    """A connection the accept loop takes once close() has stopped the
    server (before the listener is shut) is closed at once: its client
    sees EOF, and the server does not keep it."""
    srv = BusServer()
    try:
        with srv._lock:
            srv._running = False          # close()'s first step
        sock = socket.create_connection((srv.host, srv.port))
        try:
            sock.settimeout(5.0)
            assert sock.recv(1) == b""    # EOF, not a hang
            assert not srv._conns
        finally:
            sock.close()
    finally:
        srv.close()
    srv._accept_thread.join(timeout=5.0)
    assert not srv._accept_thread.is_alive()


def test_two_process_lockstep_matches_single_process(tmp_path):
    """80 lockstep cycles across two processes equal the single-process run
    of the same graph within 1e-9 (tests/test_net.py:114-115's bar), and
    the robot moves more than 5 cm."""
    truth2, slam2, steady = fstp.run_two_process(str(tmp_path), 80, 128,
                                                 "cpu")
    truth1, slam1 = fstp.run_single(80, 128, "cpu")
    assert truth2.shape == truth1.shape == (80, 3)
    assert np.max(np.abs(truth2 - truth1)) < 1e-9
    assert np.max(np.abs(slam2 - slam1)) < 1e-9
    assert np.linalg.norm(truth2[-1][1:]) > 0.05
    assert steady > 0


def test_mppi_law_graph_equals_eager():
    """Eight calls of the laptop's law (K1's plain version at K=128) on a
    moving pose and two waypoints: the eager fused solves keyed by seed
    11 + k and their twists, bit for bit."""
    import torch

    from tpunav_torch.control.mppi import init_controls
    from tpunav_torch.core import diff_drive as dd
    from tpunav_torch.models.cart import CartParams
    from tpunav_torch.ops.fused_mppi import mppi_solve_fused

    params, cfg = fstp.robot_params(), fstp.mppi_config(128)
    law = fstp.mppi_law(cfg, params, "cpu")
    cart = CartParams(params.wheel_radius, params.wheel_base)
    u = init_controls(cfg, device="cpu")
    for k in range(8):
        pose = np.array([0.01 * k, -0.02 * k, 0.1 * k])
        wpt = [0.4, 0.3] if k < 4 else [0.1, 0.6, 1.2]
        got = law(pose, wpt)
        x = torch.tensor(np.concatenate(
            [pose, wpt + [0.0] * (3 - len(wpt))]), dtype=torch.float32)
        cmd, u = mppi_solve_fused(cfg, cart, u, torch.tensor(
            11 + k, dtype=torch.int32), x[:3], x[3:])
        want = dd.wheels_to_twist(params, cmd).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_frame_over_the_cap_raises_before_its_payload_is_read(monkeypatch):
    monkeypatch.setattr(net, "MAX_FRAME_BYTES", 1 << 10)
    a, b = socket.socketpair()
    try:
        net._send_frame(a, np.zeros(8))
        np.testing.assert_array_equal(net._recv_frame(b), np.zeros(8))
        with pytest.raises(net.FrameTooLarge):
            net._send_frame(a, np.zeros(1000))
        # A header that claims more than the cap: no payload follows.
        a.sendall(net._HDR.pack((1 << 10) + 1))
        with pytest.raises(net.FrameTooLarge):
            net._recv_frame(b)
    finally:
        a.close()
        b.close()


def test_server_drops_a_client_that_sends_an_oversized_frame(monkeypatch):
    """The server takes frames up to the cap (64 MiB, far above any frame
    the node graphs send) and closes the connection of a client whose
    header claims more; other clients go on."""
    assert net.MAX_FRAME_BYTES == 64 << 20
    monkeypatch.setattr(net, "MAX_FRAME_BYTES", 1 << 12)
    srv = BusServer()
    try:
        good = BusClient(srv.host, srv.port)
        sub = good.subscribe("t")
        raw = socket.create_connection((srv.host, srv.port))
        raw.sendall(net._HDR.pack(1 << 20))
        raw.settimeout(5)
        assert raw.recv(1) == b""                  # EOF: dropped
        raw.close()
        with pytest.raises(net.FrameTooLarge):
            good.advertise("t").publish(np.zeros(4096))
        pub = good.advertise("t")
        pub.publish(np.arange(3.0))
        val, _ = wait_for_new(sub, 0, timeout=5)
        np.testing.assert_array_equal(val, np.arange(3.0))
        good.close()
    finally:
        srv.close()


def test_two_publishers_on_one_topic_get_the_brokers_seqs():
    """Two publishers on one topic, one client advertising only: each
    publish takes the seq the broker stamped, so a local consumer whose
    cursor came from remote messages sees the client's own fresh publish
    (``tpunav``'s channel stamped ``seq + 1`` locally and saw it as stale)."""
    srv = BusServer()
    try:
        a, b, c = (BusClient(srv.host, srv.port) for _ in range(3))
        sub = b.subscribe("t")
        pub_a, pub_c = a.advertise("t"), c.advertise("t")
        for i in range(3):
            pub_a.publish(np.array([float(i)]))
        assert pub_a.seq == 3
        _, cursor = wait_for_new(sub, 2, timeout=5)
        assert cursor == 3
        pub_c.publish(np.array([10.0]))
        assert pub_c.seq == 4                     # the broker's, not 1
        val, seq = pub_c.take_new(cursor)         # fresh to the consumer
        assert seq == 4
        np.testing.assert_array_equal(val, [10.0])
        val, seq = wait_for_new(sub, cursor, timeout=5)
        assert seq == 4
        np.testing.assert_array_equal(val, [10.0])
        pub_a.publish(np.array([5.0]))
        pub_c.publish(np.array([11.0]))
        assert (pub_a.seq, pub_c.seq) == (5, 6)
        val, seq = wait_for_new(sub, 5, timeout=5)
        assert seq == 6
        np.testing.assert_array_equal(val, [11.0])
        for cl in (a, b, c):
            cl.close()
    finally:
        srv.close()


def test_a_publish_after_the_bus_closed_raises():
    """With no broker to stamp it, a publish raises instead of taking a
    seq of its own."""
    srv = BusServer()
    a = BusClient(srv.host, srv.port)
    pub = a.advertise("t")
    pub.publish(np.zeros(1))
    assert pub.seq == 1
    srv.close()
    a._recv_thread.join(timeout=5.0)
    with pytest.raises(ConnectionError):
        pub.publish(np.zeros(1))
    assert pub.seq == 1
    a.close()


def test_a_late_ack_after_a_timeout_is_not_taken_by_the_next_publish(
        monkeypatch):
    """The broker is slow to ack a channel's first publish: that publish
    times out, its ack arrives afterwards, and the next publish still
    takes the seq the broker stamped on it, not the late one."""
    real, acks = net._Outbox.ack, []

    def slow_first(self, topic, seq):
        acks.append(seq)
        if len(acks) == 1:
            time.sleep(0.6)
        real(self, topic, seq)

    monkeypatch.setattr(net._Outbox, "ack", slow_first)
    monkeypatch.setattr(net, "ACK_TIMEOUT_S", 0.2)
    srv = BusServer()
    try:
        a, b = BusClient(srv.host, srv.port), BusClient(srv.host, srv.port)
        sub, pub = b.subscribe("t"), a.advertise("t")
        with pytest.raises(TimeoutError):
            pub.publish(np.array([1.0]))
        assert pub.seq == 0
        deadline = time.monotonic() + 5.0
        while pub._acked < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pub._acked == 1                    # the late ack is in
        pub.publish(np.array([2.0]))
        assert pub.seq == 2                       # its own, not the late 1
        val, seq = pub.take_new(1)
        assert seq == 2
        np.testing.assert_array_equal(val, [2.0])
        val, seq = wait_for_new(sub, 1, timeout=5)
        assert seq == 2
        np.testing.assert_array_equal(val, [2.0])
        pub.publish(np.array([3.0]))
        assert pub.seq == 3
        assert acks == [1, 2, 3]
        for cl in (a, b):
            cl.close()
    finally:
        srv.close()
