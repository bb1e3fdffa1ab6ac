"""The port's SLAM nodes against ``tpunav``'s, message by message.

Each ``tpunav`` node and its port read the same input channels, fed by
the encoders and sensors of tests/test_slam_nodes.py's graphs, and publish
on their own. The EKF node runs float64 without noise, so the
filters are held to 1e-9 over the whole graph. The RBPF node draws
randomness: each port update starts from ``tpunav``'s pre-update state,
loaded into the node's buffers in place (its ``pf`` setter), and takes the
normals ``tpunav``'s key gives (``_jax_noise``, injected as the stepper's
draw), held to the bars of ``test_pf_step_matches_tpunav``. On the CPU the
port's RBPF update runs kernels K2 and K3 as their plain versions.

The nodes' updates are ``capture.Graph`` steps, whose bodies run on the
CPU without capture: each node is also held bit for bit to its eager form
(the odometry, the filter's function and the estimates, called one by one
on the same inputs), the EKF node across a change of its messages' row
count, and the RBPF node across a checkpoint loaded through its setter.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rbpf import _jax_noise
from tpunav.core import diff_drive as jdd
from tpunav.estimation.ekf import EKFConfig as JEKFConfig
from tpunav.estimation.landmarks import LandmarkConfig as JLandmarkConfig
from tpunav.estimation.rbpf import GridConfig as JGridConfig
from tpunav.estimation.rbpf import PFConfig as JPFConfig
from tpunav.estimation.rbpf import particle_filter as jpf
from tpunav.estimation.rbpf.icp import ICPConfig as JICPConfig
from tpunav.runtime import Channel, Node, Scheduler
from tpunav.runtime import slam_nodes as jslam
from tpunav.runtime.nodes import FakeDiffEncodersNode
from tpunav.sim import lidar as jlidar
from tpunav_torch import interop
from tpunav_torch.core import diff_drive as dd
from tpunav_torch.core import se2
from tpunav_torch.estimation.ekf import EKFConfig
from tpunav_torch.estimation.landmarks import LandmarkConfig
from tpunav_torch.estimation.rbpf import PFConfig
from tpunav_torch.estimation.rbpf import grid as tg
from tpunav_torch.estimation.rbpf import icp as ticp
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.runtime import nodes, slam_nodes
from tpunav_torch.sim import landmark_measurements
from tpunav_torch.sim import lidar as tlidar

torch.set_num_threads(1)

CPU = dict(device="cpu")
LANDMARKS = torch.tensor([[0.6, 0.1], [0.4, 0.5], [-0.2, 0.6], [-0.5, -0.1],
                          [0.0, -0.6], [0.5, -0.4]], dtype=torch.float64)


def test_map_to_odom_matches_tpunav():
    """Within 1e-12 in float64, and Tmo·Tor = Tmr."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = rng.uniform([-np.pi, -2, -2], [np.pi, 2, 2], size=(2, 3))
        got = slam_nodes.map_to_odom(torch.from_numpy(a), torch.from_numpy(b))
        want = np.asarray(jslam.map_to_odom(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
        T = se2.compose(se2.make(*got), se2.make(*torch.from_numpy(b)))
        back = torch.stack([se2.theta_of(T), *se2.translation_of(T)])
        np.testing.assert_allclose(back.numpy(), a, atol=1e-12)
    # numpy poses, as the node's payloads
    np.testing.assert_allclose(
        slam_nodes.map_to_odom(a, b).numpy(),
        np.asarray(jslam.map_to_odom(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-12)


# ------------------------------------------------------------------ EKF ---

@pytest.mark.parametrize("known_da", [True, False])
def test_ekf_slam_node_matches_tpunav(known_da):
    """tests/test_slam_nodes.py:37-63's 6 s graph in float64: filter state,
    covariance and every published pose, map→odom, landmark map and
    PoseError within 1e-9 of ``tpunav``'s node."""
    cmd_vel, joints, lm, truth = Channel(), Channel(), Channel(), Channel()
    encoders = nodes.FakeDiffEncodersNode(dd.TURTLEBOT3, cmd_vel, joints,
                                          rate_hz=60.0, **CPU)
    outs = [[Channel() for _ in range(5)] for _ in range(2)]
    cfg = JEKFConfig(num_landmarks=8)
    theirs = jslam.EkfSlamNode(cfg, jdd.TURTLEBOT3, joints, lm, *outs[1][:2],
                               map_odom=outs[1][2], landmark_est=outs[1][3],
                               truth=truth, errors=outs[1][4],
                               known_da=known_da, dtype=jnp.float64)
    ours = slam_nodes.EkfSlamNode(
        EKFConfig(**dataclasses.asdict(cfg)), dd.TURTLEBOT3, joints, lm,
        *outs[0][:2], map_odom=outs[0][2], landmark_est=outs[0][3],
        truth=truth, errors=outs[0][4], known_da=known_da,
        dtype=torch.float64, **CPU)
    updates = [0]

    def sensor_tick(t):
        pose = dd.pose(encoders.state).double()
        truth.publish(pose.numpy())
        lm.publish(landmark_measurements(LANDMARKS, pose, 2.0).numpy())

    def compare(t):
        theirs.tick(t)
        ours.tick(t)
        if outs[1][0].seq == updates[0]:
            return
        updates[0] = outs[1][0].seq
        assert outs[0][0].seq == outs[1][0].seq
        for a, b in zip(ours.ekf, theirs.ekf):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-9)
        for i in (0, 1, 2, 4):
            np.testing.assert_allclose(np.asarray(outs[0][i].latest()),
                                       np.asarray(outs[1][i].latest()),
                                       rtol=0, atol=1e-9)
        np.testing.assert_allclose(outs[0][3].latest()[0],
                                   outs[1][3].latest()[0], rtol=0, atol=1e-9)
        np.testing.assert_array_equal(outs[0][3].latest()[1],
                                      outs[1][3].latest()[1])

    s = Scheduler()
    s.add(Node("cmd", 60.0, lambda t: cmd_vel.publish(
        np.asarray([0.3, 0.08, 0.0]))))
    s.add(Node("encoders", 60.0, encoders.tick))
    s.add(Node("sensor", 10.0, sensor_tick))
    s.add(Node("slam", 10.0, compare))
    s.run(6.0)
    assert updates[0] == 61
    assert isinstance(outs[0][0].latest(), np.ndarray)
    est, tru = outs[0][0].latest(), truth.latest()
    assert np.hypot(est[1] - tru[1], est[2] - tru[2]) < 0.1
    assert outs[0][3].latest()[1].sum() >= (4 if known_da else 1)


# ---------------------------------------------------------------- RBPF ---

GRID = dict(resolution=0.1, xmin=-1.5, xmax=1.5, ymin=-1.5, ymax=1.5,
            num_beams=60, beam_delta=2 * np.pi / 60, range_max=3.0)


def _label_edges(g):
    """The log-odds where ``occupancy_grid``'s label changes: the occupied
    and free thresholds, every whole percent of probability, and the
    unknown band around the prior."""
    pcts = np.arange(1, 100) / 100.0
    return np.concatenate([np.log(pcts / (1 - pcts)),
                           [np.log(g.prob_occ / (1 - g.prob_occ)),
                            np.log(g.prob_free / (1 - g.prob_free)),
                            g.l_prior - 1e-6, g.l_prior + 1e-6]])


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """``tpunav``'s update, compiled once for the file's configuration."""
    return jax.jit(lambda st, r, u, c, p: jpf.pf_slam_step(jcfg, st, r, u,
                                                           c, p))


def _rbpf_graph(twist, scan_hz, duration, monkeypatch):
    """tests/test_slam_nodes.py's RBPF graph with both nodes on it; the
    port's update starts from ``tpunav``'s pre-update state, loaded through
    the node's setter, with its normals as the stepper's draw. Checked
    after every update."""
    jcfg = JPFConfig(num_particles=4, k_samples=8,
                     motion_noise=(1e-6, 1e-5, 1e-5),
                     sample_range=(1e-6, 1e-5, 1e-5),
                     grid=JGridConfig(**GRID), icp=JICPConfig(max_iter=8))
    tcfg = interop.config_from_fields(PFConfig, dataclasses.asdict(jcfg))
    segs = jlidar.box_segments(-1.2, -1.2, 1.2, 1.2, jnp.float32)
    cmd_vel, joints, scan, truth = (Channel() for _ in range(4))
    encoders = FakeDiffEncodersNode(jdd.TURTLEBOT3, cmd_vel, joints,
                                    rate_hz=30.0)
    outs = [[Channel() for _ in range(3)] for _ in range(2)]
    theirs = jslam.RbpfMappingNode(jcfg, jdd.TURTLEBOT3, joints, scan,
                                   outs[1][0], outs[1][1],
                                   map_odom=outs[1][2], truth=truth, seed=3)
    ours = slam_nodes.RbpfMappingNode(tcfg, dd.TURTLEBOT3, joints, scan,
                                      outs[0][0], outs[0][1],
                                      map_odom=outs[0][2], truth=truth,
                                      seed=3, **CPU)
    step = _jax_step(jcfg)
    pre = []

    def their_step(st, ranges, u, cur, prev):
        pre.append(st)
        return step(st, ranges, u, cur, prev)

    theirs._step = their_step
    monkeypatch.setattr(tpf.PFStepper, "draw",
                        lambda self, noise=None: self.draws(
                            _jax_noise(jcfg, pre[-1].key)))
    edges = _label_edges(jcfg.grid)
    checked = [0]

    def scan_tick(t):
        pose = jdd.pose(encoders.state)
        truth.publish(np.asarray(pose))
        scan.publish(np.asarray(jlidar.scan_segments(
            jnp.asarray(pose, jnp.float32), segs, num_beams=60,
            beam_delta=GRID["beam_delta"], max_range=3.0)))

    def compare(t):
        theirs.tick(t)
        if outs[1][0].seq != checked[0]:
            ours.pf = interop.pf_state_from_numpy(
                {f: np.asarray(getattr(pre[-1], f)) for f in _STATE}, **CPU)
        ours.tick(t)
        if outs[1][0].seq == checked[0]:
            return
        checked[0] = outs[1][0].seq
        assert outs[0][0].seq == checked[0]
        got, want = interop.pf_state_to_numpy(ours.pf), theirs.pf
        np.testing.assert_allclose(got["poses"], np.asarray(want.poses),
                                   atol=1e-3)
        np.testing.assert_allclose(got["log_weights"],
                                   np.asarray(want.log_weights), atol=0.05)
        for name in ("grids", "dists"):
            np.testing.assert_allclose(got[name],
                                       np.asarray(getattr(want, name)),
                                       atol=1e-3)
        for i in (0, 2):
            np.testing.assert_allclose(outs[0][i].latest(),
                                       outs[1][i].latest(), atol=1e-3)
        # Occupancy labels equal but where tpunav's log-odds lie within
        # 1e-3 of a label edge.
        best = int(np.argmax(np.asarray(want.log_weights)))
        lo = np.asarray(want.grids)[best]
        near = (np.abs(lo[..., None] - edges) < 1e-3).any(-1)
        a, b = outs[0][1].latest(), outs[1][1].latest()
        assert a.dtype == np.int8 and a.shape == b.shape
        assert np.array_equal(a[~near], b[~near])

    s = Scheduler()
    s.add(Node("cmd", 30.0, lambda t: cmd_vel.publish(np.asarray(twist))))
    s.add(Node("encoders", 30.0, encoders.tick))
    s.add(Node("scan", scan_hz, scan_tick))
    s.add(Node("slam", scan_hz, compare))
    s.run(duration)
    return outs[0], truth, encoders, checked[0]


_STATE = ("poses", "prev_poses", "log_weights", "grids", "dists",
          "prev_scan", "has_prev")


def test_rbpf_mapping_node_matches_tpunav(monkeypatch):
    """tests/test_slam_nodes.py:107-153's graph: every update within the
    bars of test_pf_step_matches_tpunav; the map has walls and free cells;
    map→odom published."""
    (slam_pose, grid_out, map_odom), truth, _, updates = _rbpf_graph(
        [0.2, 0.06, 0.0], 4.0, 1.5, monkeypatch)
    assert updates == 7
    est, tru = slam_pose.latest(), truth.latest()
    assert np.all(np.isfinite(est))
    assert np.hypot(est[1] - tru[1], est[2] - tru[2]) < 0.3
    omap = grid_out.latest()
    assert omap.shape == (30, 30)
    assert (omap == 100).sum() > 0 and (omap == 0).sum() > 0
    assert map_odom.latest() is not None


def test_rbpf_mapping_node_reverse_drive(monkeypatch):
    """tests/test_slam_nodes.py:156's case: driving backwards, the node
    feeds the filter a signed body twist, so the estimate goes backwards
    too."""
    (slam_pose, _, _), _, encoders, updates = _rbpf_graph(
        [0.0, -0.08, 0.0], 2.0, 1.2, monkeypatch)
    assert updates == 3
    tru = np.asarray(jdd.pose(encoders.state))
    est = slam_pose.latest()
    assert tru[1] < -0.05 and est[1] < -0.02
    assert abs(est[1] - tru[1]) < 0.1


# ------------------------------------------------------------ detector ---

def test_landmarks_node_matches_tpunav():
    """360-beam scans of cylinders: the port's float32 node within 1e-5 m
    of ``tpunav``'s float64 node, message by message, and the TurtleMap
    triple's valid mask equal."""
    from tpunav_torch.sim import lidar

    centers = torch.tensor([[1.0, 0.2], [0.3, 1.1], [-0.9, -0.4],
                            [0.6, -1.2], [-0.2, 0.9]], dtype=torch.float64)
    radii = torch.full((5,), 0.05, dtype=torch.float64)
    scan = Channel()
    outs = [[Channel(), Channel()] for _ in range(2)]
    ours = slam_nodes.LandmarksNode(LandmarkConfig(max_clusters=16), scan,
                                    *outs[0], **CPU)
    theirs = jslam.LandmarksNode(JLandmarkConfig(max_clusters=16), scan,
                                 *outs[1], dtype=jnp.float64)
    rng = np.random.default_rng(2)
    for i in range(4):
        pose = torch.tensor([0.4 * i, 0.05 * i, -0.03 * i],
                            dtype=torch.float64)
        scan.publish(lidar.scan_cylinders(
            pose, centers, radii, noise_std=1e-3,
            noise=torch.from_numpy(rng.standard_normal(360))).numpy())
        ours.tick(0.0)
        theirs.tick(0.0)
        got, want = outs[0][0].latest(), outs[1][0].latest()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.isfinite(got).all(-1).sum() >= 2
        np.testing.assert_array_equal(outs[0][1].latest()[2],
                                      outs[1][1].latest()[2])


# ------------------------------------------- the graphs against eager ---

def _drive_node(node, channels, cmd, ticks, sense_every, sense, start=0,
                encoders=None):
    """Fake encoders at 60 Hz on ``cmd`` into ``node`` over ticks ``start``
    to ``ticks`` (``encoders`` carries on an earlier call's);
    ``sense(k, drive)`` publishes a message every ``sense_every`` ticks.
    Returns, per update the node published, the odometry it read, the
    message and the published payloads of ``channels``; and the
    encoders."""
    cmd_vel = Channel()
    if encoders is None:
        encoders = nodes.FakeDiffEncodersNode(dd.TURTLEBOT3, cmd_vel,
                                              node.joints, rate_hz=60.0,
                                              **CPU)
    cmd_vel = encoders.cmd_vel
    out_seq, records = channels[0].seq, []
    for k in range(start, ticks):
        cmd_vel.publish(np.asarray(cmd))
        encoders.tick(k / 60.0)
        if k % sense_every == sense_every - 1:
            msg = sense(k, encoders.state)
        node.tick(k / 60.0)
        if channels[0].seq != out_seq:
            out_seq = channels[0].seq
            records.append((node.drive, msg, [c.latest() for c in channels]))
    return records, encoders


def _ekf_eager(cfg, known, records, dtype):
    """The eager EKF node: the filter-input odometry, the update and the
    estimates, called one by one on the recorded inputs."""
    from tpunav_torch.estimation.ekf import filter as tf

    step = (tf.known_correspondence_slam if known else tf.slam_unknown_da)
    st = tf.ekf_init(cfg, dtype=dtype, **CPU)
    ekf_drive = dd.init_state(dtype=dtype, **CPU)
    out = []
    for drive, meas, _ in records:
        ekf_drive, wheel_vel = dd.update_odometry(
            dd.TURTLEBOT3, ekf_drive, drive.left, drive.right)
        u = dd.wheels_to_twist(dd.TURTLEBOT3, wheel_vel)[:2]
        st = step(cfg, st, torch.as_tensor(meas, dtype=dtype), u)
        pose = tf.robot_pose(st)
        centers, active = tf.landmark_map(cfg, st)
        out.append((pose, slam_nodes.map_to_odom(pose, dd.pose(drive)),
                    centers, active))
    return st, out


def _ekf_node_against_eager(known, rows):
    """An EkfSlamNode (float32, the default SPD repair) whose k-th message
    has ``rows(k)`` rows, against its eager form bit for bit: every
    published pose, map→odom and landmark map, and the final state."""
    cfg = EKFConfig(num_landmarks=8)
    ch = [Channel() for _ in range(4)]
    lm = Channel()
    node = slam_nodes.EkfSlamNode(cfg, dd.TURTLEBOT3, Channel(), lm, ch[0],
                                  Channel(), map_odom=ch[1],
                                  landmark_est=ch[2], known_da=known, **CPU)
    sent = [0]

    def sense(k, drive):
        m = landmark_measurements(LANDMARKS.float(), dd.pose(drive),
                                  2.0).numpy()
        n = rows(sent[0])
        sent[0] += 1
        m = np.concatenate([m, np.full((max(n - len(m), 0), 2), np.nan,
                                       np.float32)])[:n]
        lm.publish(m)
        return m

    records, _ = _drive_node(node, ch[:3], [0.3, 0.08, 0.0], 150, 6, sense)
    assert len(records) == 25
    st, want = _ekf_eager(cfg, known, records, torch.float32)
    for (_, _, (pose, m2o, (centers, active))), (p, o, c, a) in zip(records,
                                                                    want):
        assert pose.dtype == np.float32
        np.testing.assert_array_equal(pose, p.numpy())
        np.testing.assert_array_equal(m2o, o.numpy())
        np.testing.assert_array_equal(centers, c.numpy())
        np.testing.assert_array_equal(active, a.numpy())
    for name, x, y in zip(st._fields, node.ekf, st):
        assert torch.equal(x, y), name
    assert int(node.ekf.count) >= 3
    return node


@pytest.mark.parametrize("known_da", [True, False])
def test_ekf_slam_node_graph_equals_eager(known_da):
    """25 updates of 6 rows through the node's graph step: its eager form's
    bits."""
    node = _ekf_node_against_eager(known_da, lambda k: 6)
    assert node._stepper.inputs[0].shape == (6, 2)


@pytest.mark.parametrize("known_da", [True, False])
def test_ekf_slam_node_rebuilds_on_a_new_row_count(known_da):
    """Messages of 6, then 8 (two NaN rows), then 5 rows: the node rebuilds
    its stepper from the current state at each new count and keeps its
    eager form's bits."""
    node = _ekf_node_against_eager(
        known_da, lambda k: 6 if k < 8 else 8 if k < 16 else 5)
    assert node._stepper.inputs[0].shape == (5, 2)


def _rbpf_node(seed=3):
    """The port's RBPF node on GRID's small map (P=4, k=8), float32."""
    cfg = PFConfig(num_particles=4, k_samples=8,
                   motion_noise=(1e-6, 1e-5, 1e-5),
                   sample_range=(1e-6, 1e-5, 1e-5),
                   grid=tg.GridConfig(**GRID), icp=ticp.ICPConfig(max_iter=8))
    ch = [Channel() for _ in range(3)]
    scan = Channel()
    node = slam_nodes.RbpfMappingNode(cfg, dd.TURTLEBOT3, Channel(), scan,
                                      ch[0], ch[1], map_odom=ch[2],
                                      seed=seed, **CPU)
    segs = tlidar.box_segments(-1.2, -1.2, 1.2, 1.2, **CPU)

    def sense(k, drive):
        ranges = tlidar.scan_segments(
            dd.pose(drive), segs, num_beams=60,
            beam_delta=GRID["beam_delta"], max_range=3.0,
            generator=torch.Generator().manual_seed(k),
            noise_std=0.005).numpy()
        scan.publish(ranges)
        return ranges

    return cfg, node, ch, sense


def _rbpf_eager(cfg, records, seed=3):
    """The eager RBPF node: the filter-input odometry, ``pf_slam_step``
    with its generator's draws, and the estimates, one by one."""
    st = tpf.pf_init(cfg, seed=seed, **CPU)
    pf_drive = dd.init_state(**CPU)
    prev, out = torch.zeros(3), []
    for drive, ranges, _ in records:
        pf_drive, wheel_vel = dd.update_odometry(dd.TURTLEBOT3, pf_drive,
                                                 drive.left, drive.right)
        u = dd.wheels_to_twist(dd.TURTLEBOT3, wheel_vel)[:2]
        cur = dd.pose(drive)
        st = tpf.pf_slam_step(cfg, st, torch.as_tensor(ranges), u, cur, prev)
        prev = cur
        pose, grid = tpf.best_particle(st)
        out.append((pose, tg.occupancy_grid(cfg.grid, grid),
                    slam_nodes.map_to_odom(pose, cur)))
    return st, out


def _assert_pf_equal(got, want):
    for name, x, y in zip(tpf.PFState._fields[:-1], got[:-1], want[:-1]):
        assert torch.equal(x, y), name
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_rbpf_mapping_node_graph_equals_eager():
    """8 updates through the node's graph step (its normals drawn from the
    filter's generator before each replay): its eager form's published
    pose, grid and map→odom, and its state with the generator's, bit for
    bit."""
    cfg, node, ch, sense = _rbpf_node()
    records, _ = _drive_node(node, ch, [0.2, 0.06, 0.0], 100, 12, sense)
    assert len(records) == 8
    st, want = _rbpf_eager(cfg, records)
    for (_, _, (pose, grid, m2o)), (p, g, o) in zip(records, want):
        np.testing.assert_array_equal(pose, p.numpy())
        assert grid.dtype == np.int8
        np.testing.assert_array_equal(grid, g.numpy())
        np.testing.assert_array_equal(m2o, o.numpy())
    _assert_pf_equal(node.pf, st)


def test_rbpf_mapping_node_resumes_a_checkpoint_through_its_setter(tmp_path):
    """The node's state saved after 4 updates, then another state and the
    checkpoint assigned to ``node.pf`` in turn: the buffers the graph
    replays are loaded in place (never rebound), and 4 more updates give
    the uninterrupted 8's state."""
    from tpunav_torch.runtime import load_pytree, save_pytree

    cfg, node, ch, sense = _rbpf_node()
    whole, _ = _drive_node(node, ch, [0.2, 0.06, 0.0], 100, 12, sense)
    want = node.pf
    cfg, node, ch, sense = _rbpf_node()
    first, encoders = _drive_node(node, ch, [0.2, 0.06, 0.0], 50, 12, sense)
    assert len(first) == 4
    path = str(tmp_path / "pf.npz")
    save_pytree(path, node.pf)
    buffers = [t.data_ptr() for t in node.pf[:-1]]
    gen = node.pf.generator
    node.pf = tpf.pf_init(cfg, seed=99, **CPU)
    node.pf = load_pytree(path, tpf.pf_init(cfg, seed=123, **CPU))
    assert [t.data_ptr() for t in node.pf[:-1]] == buffers
    assert node.pf.generator is gen
    rest, _ = _drive_node(node, ch, [0.2, 0.06, 0.0], 100, 12, sense,
                          start=50, encoders=encoders)
    assert len(first) + len(rest) == len(whole)
    _assert_pf_equal(node.pf, want)
