"""The port's host runtime against ``tpunav``'s: channels and the
scheduler (copied), metrics, the hardware-chain nodes message by message,
the node graph's closed loop, checkpoints, profiling, the live view, the
robot model and the drawing helpers.

Nodes run on the CPU (``device="cpu"``), as tests/test_runtime.py runs
``tpunav``'s. A ``tpunav`` node and its port read the same input channels;
before each message the port's node takes the ``tpunav`` node's state, so
each message is compared from equal inputs.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.core import diff_drive as jdd
from tpunav.runtime import nodes as jnodes
from tpunav_torch.core import diff_drive as dd
from tpunav_torch.runtime import (Channel, Metrics, Node, PoseError,
                                  Scheduler, load_pytree, save_pytree)
from tpunav_torch.runtime.nodes import (FakeDiffEncodersNode, OdometerNode,
                                        RotationNode, TurtleInterfaceNode,
                                        WaypointDriverNode)

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _dd_state(jst, dtype=torch.float32):
    """The port's DiffDriveState holding a ``tpunav`` state's values."""
    return dd.DiffDriveState(*(torch.as_tensor(np.array(v)).to(dtype)
                               for v in jst))


# ----------------------------------------------- channels and scheduler ---

def test_channel_latest_wins():
    ch = Channel("x")
    assert ch.latest() is None
    ch.publish(1)
    ch.publish(2)
    assert ch.latest() == 2
    v, seen = ch.take_new(0)
    assert v == 2 and seen == 2
    v2, seen = ch.take_new(seen)
    assert v2 is None


def test_scheduler_deterministic_order():
    log = []
    s = Scheduler()
    s.add(Node("a", 10.0, lambda t: log.append(("a", round(t, 3)))))
    s.add(Node("b", 5.0, lambda t: log.append(("b", round(t, 3)))))
    s.run(0.35)
    # a fires at 0, .1, .2, .3; b at 0, .2 — ties broken by add order.
    assert log == [("a", 0.0), ("b", 0.0), ("a", 0.1), ("a", 0.2),
                   ("b", 0.2), ("a", 0.3)]


def test_scheduler_early_break_time_bookkeeping():
    """`until` firing mid-run leaves virtual time at the tick that
    satisfied it (channels.py:85-112), and a resumed run continues from
    the next tick."""
    fired = []
    s = Scheduler()
    s.add(Node("n", 10.0, lambda t: fired.append(t)))
    t = s.run(100.0, until=lambda: len(fired) >= 4)
    assert len(fired) == 4
    assert np.isclose(t, 0.3) and np.isclose(s.t, 0.3)
    t2 = s.run(0.25)
    assert np.isclose(t2, 0.55)
    assert np.isclose(fired[4], 0.4)


def test_scheduler_empty_heap_advances_to_end():
    s = Scheduler()
    assert np.isclose(s.run(1.5), 1.5)
    assert np.isclose(s.run(1.0), 2.5)


def test_metrics_and_pose_error():
    m = Metrics()
    for v in [1.0, 2.0, 3.0]:
        m.record("err", v)
    s = m.summary()["err"]
    assert s["mean"] == 2.0 and s["n"] == 3 and s["last"] == 3.0
    m.start("solve")
    assert m.stop("solve") >= 0.0 and m.summary()["solve_ms"]["n"] == 1
    pe = PoseError.between(np.array([0.1, 1.0, 2.0]),
                           np.array([0.0, 0.5, 2.5]))
    assert np.isclose(pe.x_error, 0.5)
    assert np.isclose(pe.y_error, -0.5)
    assert np.isclose(pe.theta_error, 0.1)
    # Heading error wraps across ±π.
    assert np.isclose(PoseError.between([3.1, 0, 0], [-3.1, 0, 0])
                      .theta_error, 6.2 - 2 * np.pi)


# --------------------------------------------------- hardware-chain nodes ---

def test_turtle_interface_golden_wheel_commands():
    # Golden integers from the reference integration test
    # (turtle_interface_test_node.cpp:111-177).
    cmd, wheel, sensor, joints = (Channel() for _ in range(4))
    node = TurtleInterfaceNode(dd.TURTLEBOT3, cmd, wheel, sensor, joints,
                               **CPU)
    for twist, want in [([0.0, 0.1, 0.0], (126, 126)),
                        ([1.0, 0.0, 0.0], (-101, 101)),
                        ([1.0, 0.01, 0.0], (-88, 114))]:
        cmd.publish(twist)
        node.tick(0.0)
        assert wheel.latest() == want


def test_turtle_interface_encoder_to_joint_state():
    # 100 ticks → 2π·100/4096 = 0.153398 rad (ref: :227-231), and the
    # encoder-derived velocities: the first update moves the wheels by
    # 0.153398, a repeat of the same ticks reads 0.
    cmd, wheel, sensor, joints = (Channel() for _ in range(4))
    node = TurtleInterfaceNode(dd.TURTLEBOT3, cmd, wheel, sensor, joints,
                               **CPU)
    sensor.publish((100, 100))
    node.tick(0.0)
    for v in joints.latest():
        assert np.isclose(v, 0.153398, atol=1e-5)
    sensor.publish((100, 100))
    node.tick(1.0)
    _, _, vl, vr = joints.latest()
    assert vl == 0.0 and vr == 0.0


def test_turtle_interface_clamps():
    cmd, wheel, sensor, joints = (Channel() for _ in range(4))
    node = TurtleInterfaceNode(dd.TURTLEBOT3, cmd, wheel, sensor, joints,
                               **CPU)
    for twist in ([100.0, 100.0, 0.0], [-100.0, 100.0, 0.0],
                  [0.0, -100.0, 0.0]):
        cmd.publish(twist)
        node.tick(0.0)
        left, right = wheel.latest()
        assert abs(left) <= 265 and abs(right) <= 265


def test_turtle_interface_matches_tpunav():
    """Integer wheel commands equal (clamped twists included); joints within
    1e-6 from equal inputs at each message."""
    chans = [[Channel() for _ in range(4)] for _ in range(2)]
    ours = TurtleInterfaceNode(dd.TURTLEBOT3, *chans[0], **CPU)
    theirs = jnodes.TurtleInterfaceNode(jdd.TURTLEBOT3, *chans[1])
    rng = np.random.default_rng(0)
    ticks = np.zeros(2, np.int64)
    for _ in range(60):
        twist = rng.uniform([-4.0, -0.4, 0.0], [4.0, 0.4, 0.0])
        ticks += rng.integers(-300, 900, size=2)
        for cmd, _, sensor, _ in chans:
            cmd.publish(twist)
            sensor.publish(tuple(int(v) for v in ticks))
        ours.state = _dd_state(theirs.state)
        theirs.tick(0.0)
        ours.tick(0.0)
        assert chans[0][1].latest() == chans[1][1].latest()
        np.testing.assert_allclose(chans[0][3].latest(), chans[1][3].latest(),
                                   rtol=0, atol=1e-6)


def test_odometer_and_fake_encoders_match_tpunav():
    """Each message from equal inputs: the odometry pose and the encoder
    joint angles within 1e-6 (float32)."""
    rng = np.random.default_rng(1)
    joints, odom = [Channel(), Channel()], [Channel(), Channel()]
    ours = OdometerNode(dd.TURTLEBOT3, joints[0], odom[0], **CPU)
    theirs = jnodes.OdometerNode(jdd.TURTLEBOT3, joints[1], odom[1])
    lr = np.zeros(2)
    for _ in range(40):
        lr = lr + rng.uniform(-0.4, 0.6, size=2)
        msg = (float(lr[0]), float(lr[1]), 0.0, 0.0)
        for ch in joints:
            ch.publish(msg)
        ours.state = _dd_state(theirs.state)
        theirs.tick(0.0)
        ours.tick(0.0)
        np.testing.assert_allclose(odom[0].latest(), odom[1].latest(),
                                   rtol=0, atol=1e-6)
    assert ours.set_pose(0.5, 1.0, -1.0)
    np.testing.assert_allclose(odom[0].latest(), [0.5, 1.0, -1.0], atol=1e-7)

    cmd, out = [Channel(), Channel()], [Channel(), Channel()]
    ours = FakeDiffEncodersNode(dd.TURTLEBOT3, cmd[0], out[0], 60.0, **CPU)
    theirs = jnodes.FakeDiffEncodersNode(jdd.TURTLEBOT3, cmd[1], out[1], 60.0)
    for _ in range(40):
        twist = rng.uniform([-2.8, -0.22, 0.0],
                            [2.8, 0.22, 0.0]).astype(np.float32)
        for ch in cmd:
            ch.publish(twist)
        ours.state = _dd_state(theirs.state)
        theirs.tick(0.0)
        ours.tick(0.0)
        np.testing.assert_allclose(out[0].latest(), out[1].latest(), rtol=0,
                                   atol=1e-6)


def test_node_graph_closed_loop_waypoint():
    """The reference's mppi_waypoints launch graph as a Scheduler run
    (tests/test_runtime.py:167-200): driver → cmd_vel → fake encoders →
    joint_states → odometer → odom → driver, with a P-controller law."""
    from tpunav_torch.core import waypoints as wp

    cmd_vel, joints, odom = Channel(), Channel(), Channel()
    encoders = FakeDiffEncodersNode(dd.TURTLEBOT3, cmd_vel, joints,
                                    rate_hz=60.0, **CPU)
    odometer = OdometerNode(dd.TURTLEBOT3, joints, odom, **CPU)
    params = wp.make_params([[0.3, 0.0]], rot_vel=2.84, trans_vel=0.1,
                            k_rot=2.0, dtype=torch.float64, **CPU)

    def control_law(pose_xyt, wpt):
        pose = torch.tensor([pose_xyt[2], pose_xyt[0], pose_xyt[1]],
                            dtype=torch.float64)
        cmd, _ = wp.next_waypoint_closed_loop(params, wp.init_state(**CPU),
                                              pose)
        return cmd.numpy()

    driver = WaypointDriverNode(odom, cmd_vel, [[0.3, 0.0, 0.0]],
                                control_law, goal_thresh=0.05)
    driver.start()
    odom.publish(np.zeros(3))
    s = Scheduler()
    s.add(Node("driver", 60.0, driver.tick))
    s.add(Node("encoders", 60.0, encoders.tick))
    s.add(Node("odometer", 60.0, odometer.tick))
    s.run(20.0, until=lambda: driver.done)

    assert driver.done, f"never reached waypoint; odom={odom.latest()}"
    pose = np.asarray(odom.latest())
    assert isinstance(odom.latest(), np.ndarray)
    assert np.hypot(pose[1] - 0.3, pose[2]) < 0.06
    assert np.array_equal(cmd_vel.latest(), np.zeros(3))    # stopped


@pytest.mark.parametrize("direction,ang,lin", [
    ("counter-clockwise", 20 * 2 * np.pi, 0.0), ("forward", 0.0, 2.0),
    ("backward", 0.0, -2.0)])
def test_rotation_node(direction, ang, lin):
    node = RotationNode(Channel("cmd"), direction=direction, frac_vel=0.5)
    total = {"ang": 0.0, "lin": 0.0}

    def plant(t):
        node.tick(t)
        c = node.cmd_vel.latest()
        total["ang"] += float(c[0]) / 110.0
        total["lin"] += float(c[1]) / 110.0

    s = Scheduler()
    s.add(Node("rot", 110.0, plant))
    s.run(3000.0, until=lambda: node.done)
    assert node.done
    assert np.isclose(total["ang"], ang, rtol=0.02)
    assert np.isclose(total["lin"], lin, rtol=0.02)
    with pytest.raises(ValueError):
        RotationNode(Channel("cmd"), direction="sideways")


# ------------------------------------------------------------ checkpoint ---

def _pf_course():
    from tpunav_torch.estimation.rbpf import GridConfig, PFConfig
    from tpunav_torch.estimation.rbpf.icp import ICPConfig
    from tpunav_torch.sim import lidar

    grid = GridConfig(resolution=0.1, xmin=-1.5, xmax=1.5, ymin=-1.5,
                      ymax=1.5, num_beams=60,
                      beam_delta=2 * np.pi / 60, range_max=3.0)
    cfg = PFConfig(num_particles=4, k_samples=6,
                   motion_noise=(1e-6, 1e-5, 1e-5),
                   sample_range=(1e-6, 1e-5, 1e-5), grid=grid,
                   icp=ICPConfig(max_iter=6))
    segs = lidar.box_segments(-1.2, -1.2, 1.2, 1.2, **CPU)
    u = torch.tensor([0.05, 0.03])
    poses = [torch.tensor([0.05 * i, 0.03 * i, 0.0]) for i in range(5)]
    scans = [lidar.scan_segments(p, segs, num_beams=60,
                                 beam_delta=grid.beam_delta, max_range=3.0)
             for p in poses]
    return cfg, u, poses, scans


def test_checkpoint_pf_state_resumes_exactly(tmp_path):
    """A PFState with its generator, saved after 2 updates and loaded into
    a fresh template with another seed: 2 more updates equal 4
    uninterrupted, bit for bit."""
    from tpunav_torch.estimation.rbpf import pf_init, pf_slam_step

    cfg, u, poses, scans = _pf_course()

    def run(st, lo, hi):
        for i in range(lo, hi):
            st = pf_slam_step(cfg, st, scans[i + 1], u, poses[i + 1],
                              poses[i])
        return st

    whole = run(pf_init(cfg, seed=5, **CPU), 0, 4)
    half = run(pf_init(cfg, seed=5, **CPU), 0, 2)
    path = str(tmp_path / "pf.npz")
    save_pytree(path, half)
    template = pf_init(cfg, seed=99, **CPU)
    loaded = load_pytree(path, template)
    assert isinstance(loaded.generator, torch.Generator)
    assert loaded.generator is not template.generator
    assert torch.equal(loaded.generator.get_state(),
                       half.generator.get_state())
    resumed = run(loaded, 2, 4)
    for name in ("poses", "prev_poses", "log_weights", "grids", "dists",
                 "prev_scan", "has_prev"):
        assert torch.equal(getattr(resumed, name), getattr(whole, name)), name


def test_checkpoint_int_leaf_and_containers(tmp_path):
    """A course state's int seed comes back an int; tuples, dicts (sorted
    like jax.tree) and None round-trip; the template sets dtype."""
    from tpunav_torch.control.mppi import MPPIConfig
    from tpunav_torch.control.waypoint_loop import course_init

    st = course_init(MPPIConfig(horizon=0.1), [0.1, 0.2, 0.3], seed=7, **CPU)
    tree = {"b": st, "a": (dd.init_state(0.3, 1.0, -2.0, **CPU), None)}
    path = str(tmp_path / "c.npz")
    save_pytree(path, tree)
    template = {"b": course_init(MPPIConfig(horizon=0.1), [0, 0, 0], seed=0,
                                 **CPU),
                "a": (dd.init_state(dtype=torch.float64, **CPU), None)}
    got = load_pytree(path, template)
    assert list(got) == ["b", "a"] and got["a"][1] is None
    assert got["b"].seed == 7 and type(got["b"].seed) is int
    assert torch.equal(got["b"].pose, st.pose)
    assert torch.equal(got["b"].generator.get_state(),
                       st.generator.get_state())
    assert got["a"][0].pose.dtype == torch.float64
    np.testing.assert_allclose(got["a"][0].pose.numpy(),
                               tree["a"][0].pose.numpy())


def test_checkpoint_loads_tpunav_ekf_state(tmp_path):
    """``tpunav``'s EKFState checkpoint loads into the port's template with
    the same values (the two packages' EKFState share their fields)."""
    from tpunav.estimation.ekf import EKFConfig as JEKFConfig
    from tpunav.estimation.ekf import ekf_init as jekf_init
    from tpunav.estimation.ekf import known_correspondence_slam as jknown
    from tpunav.runtime import save_pytree as jsave
    from tpunav_torch.estimation.ekf import EKFConfig, EKFState, ekf_init

    jcfg = JEKFConfig(num_landmarks=4)
    jst = jknown(jcfg, jekf_init(jcfg, dtype=jnp.float64),
                 jnp.asarray([[0.5, 0.1], [np.nan, np.nan], [-0.2, 0.4]]),
                 jnp.asarray([0.1, 0.05]))
    path = str(tmp_path / "ekf.npz")
    jsave(path, jst)
    got = load_pytree(path, ekf_init(EKFConfig(num_landmarks=4), **CPU))
    assert isinstance(got, EKFState)
    for name in EKFState._fields:
        want = np.asarray(getattr(jst, name))
        have = getattr(got, name).numpy()
        assert have.dtype == want.dtype, name
        np.testing.assert_array_equal(have, want)


def test_checkpoint_leaf_count_mismatch_raises(tmp_path):
    path = str(tmp_path / "s.npz")
    save_pytree(path, dd.init_state(**CPU))
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, (dd.init_state(**CPU), torch.zeros(2)))


# ------------------------------------------------------------- profiling ---

def test_solve_profiler_records_rate():
    from tpunav_torch.runtime import SolveProfiler

    prof = SolveProfiler(lambda x: (torch.sin(x).sum(), {"y": x * 2}),
                         name="toy")
    for _ in range(5):
        out = prof(torch.ones(128))
    assert float(out[0]) == pytest.approx(128 * np.sin(1.0))
    s = prof.summary()
    assert s["n"] == 5 and s["mean"] > 0
    assert prof.hz() > 0
    assert SolveProfiler(lambda: None).hz() == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    from tpunav_torch.runtime import enable, span, trace

    enable(True)
    try:
        with trace(str(tmp_path)):
            with span("region"):
                (torch.ones(8) * 2).sum()
    finally:
        enable(False)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)


# ------------------------------------------------------ live view, model ---

def test_live_view_node(tmp_path):
    """Renders subscribed state to an atomically-replaced PNG, re-rendering
    only on fresh publishes."""
    from tpunav_torch.runtime.live import LiveViewNode

    slam, truth, lms = Channel("slam_pose"), Channel("truth"), Channel()
    out = str(tmp_path / "live.png")
    view = LiveViewNode(out, slam_pose=slam, truth_pose=truth,
                        landmark_est=lms,
                        landmarks_true=np.array([[1.0, 0.0]]),
                        bounds=(-1, 2, -1, 1))
    view.tick(0.0)
    assert view.frames == 0 and not os.path.exists(out)

    slam.publish(np.array([0.0, 0.1, 0.0]))
    truth.publish(np.array([0.0, 0.11, 0.01]))
    lms.publish((np.array([[0.9, 0.1], [0.0, 0.0]]), np.array([True, False])))
    view.tick(0.1)
    assert view.frames == 1
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    mtime = os.path.getmtime(out)
    view.tick(0.2)
    assert view.frames == 1 and os.path.getmtime(out) == mtime
    slam.publish(np.array([0.1, 0.2, 0.0]))
    view.tick(0.3)
    assert view.frames == 2 and len(view.trails["slam"]) == 2


@pytest.mark.parametrize("scale", [1.0, 1.5])
def test_robot_model_equals_tpunav(scale):
    from tpunav.robot_model import build_model as jbuild
    from tpunav.runtime.config import RobotConfig as JRobotConfig
    from tpunav_torch.robot_model import (CHASSIS_MASS, TURTLEBOT3_MODEL,
                                          WHEEL_MASS, build_model)
    from tpunav_torch.runtime.config import RobotConfig

    fields = {k: v * scale if isinstance(v, float) else v
              for k, v in dataclasses.asdict(RobotConfig()).items()}
    ours, theirs = (build_model(RobotConfig(**fields)),
                    jbuild(JRobotConfig(**fields)))
    assert ({k: dataclasses.asdict(v) for k, v in ours.links.items()} ==
            {k: dataclasses.asdict(v) for k, v in theirs.links.items()})
    np.testing.assert_array_equal(ours.footprint(), theirs.footprint())
    assert ours.bounding_radius() == theirs.bounding_radius()
    assert ours.caster_radius == theirs.caster_radius
    assert (CHASSIS_MASS, WHEEL_MASS) == (0.94, 0.03)
    assert TURTLEBOT3_MODEL.config == RobotConfig()


def test_viz_draws_from_cpu_tensors(tmp_path):
    from tpunav_torch import viz
    from tpunav_torch.estimation.rbpf import GridConfig

    cfg = GridConfig(resolution=0.1, xmin=-2, xmax=2, ymin=-2, ymax=2)
    prob = torch.rand((cfg.height, cfg.width),
                      generator=torch.Generator().manual_seed(0))
    ax = viz.draw_occupancy(cfg, prob)
    viz.draw_landmarks(torch.tensor([[0.5, 0.5], [-1.0, 0.2]]),
                       radii=torch.tensor([0.1, 0.2]), ax=ax,
                       truth=torch.tensor([[0.52, 0.52]]))
    viz.draw_world([torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])],
                   bounds=[(-2, 2), (-2, 2)], ax=ax)
    t = torch.linspace(0, 2 * np.pi, 50)
    viz.draw_path(torch.stack([torch.cos(t), torch.sin(t)], -1), ax=ax,
                  label="path")
    viz.draw_robot(torch.tensor([0.3, 0.5, -0.5]), ax=ax)
    out = viz.save(ax, str(tmp_path / "map.png"), title="test")
    assert os.path.getsize(out) > 1000
    series = viz.plot_series({"a": torch.sin(t), "n": torch.arange(50)},
                             [("amp", ["a"]), ("count", ["n"])],
                             str(tmp_path / "series.png"), x=t)
    assert os.path.getsize(series) > 1000
