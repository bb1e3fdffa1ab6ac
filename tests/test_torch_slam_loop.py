"""The port's SLAM-in-the-loop course (``control/slam_loop.py``, BASELINE
configs 3 and 4) against ``tpunav``'s.

- 30 ticks of ``tpunav.control.slam_loop.slam_loop_tick`` (plain backend),
  each beside the port's tick from the same state, carried across with
  ``tpunav_torch.interop``. The test replays ``tpunav``'s key splits and
  hands each tick's MPPI perturbations (``noise=``) and the sensor's
  normals (``meas_noise=``) to the port, on both port backends
  (``use_fused`` False and True; on the CPU the fused one is K1's plain
  version) and for known and unknown DA. True pose, EKF pose and u agree
  within 1e-4; a u row may differ only where the float64 cost-to-go of
  that tick shows a near-tie. Each tick starts from ``tpunav``'s state:
  run apart, the two float32 filters' poses drift ~1e-7 apart, which the
  λ = 0.01 softmax turns into u differences of ~1e-4 within 25 ticks.
- The sensor runs on sensing ticks only (``tpunav`` runs it every tick and
  masks it to NaN).
- Whole courses: tests/test_slam_loop.py's assertions for both DAs, the
  lidar → detector → EKF chains of tests/test_perception_loop.py, and the
  dense world's closed loop (config 4, shrunk as tpunav's CI shrinks it)
  through K1's plain version.
- The plain backend's replayed chunks (``capture.Graph``'s CPU path runs
  the body the card replays): ``run_slam_loop`` stopping mid-chunk on done
  and on ``max_ticks``, from a tick off the sensing schedule, and
  ``run_slam_course`` with telemetry and a short last chunk, each against
  the eager per-tick loop bit for bit, the generator included (its MPPI
  perturbations and the sensor's normals interleave on one stream).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.control import mppi as jm
from tpunav.control import slam_loop as jsl
from tpunav.estimation.ekf import EKFConfig as JEKFConfig
from tpunav.models.cart import CartParams as JCartParams
from tpunav_torch import interop
from tpunav_torch.control.mppi import MPPIConfig, cost_to_go, rollout_losses
from tpunav_torch.control.slam_loop import (SlamLoopConfig, run_slam_course,
                                            run_slam_loop, slam_loop_init,
                                            slam_loop_tick)
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.estimation import landmarks as tl
from tpunav_torch.estimation.ekf import filter as tf
from tpunav_torch.models.cart import CartParams
from tpunav_torch.sim import associate_known, scan_cylinders

torch.set_num_threads(1)

MODEL = CartParams(0.033, 0.160)
# tests/test_slam_loop.py's world.
LANDMARKS = [[0.6, 0.1], [0.4, 0.5], [-0.2, 0.6], [-0.5, -0.1],
             [0.0, -0.6], [0.5, -0.4], [0.8, 0.6], [-0.6, 0.5]]
WAYPOINTS = [[0.4, 0.0, 0.0], [0.3, 0.4, 1.57], [-0.3, 0.3, 3.0]]
MPPI_KW = dict(horizon=0.4, dt=0.05, rollouts=256, ul_var=4.0, ur_var=4.0)
EKF_KW = dict(num_landmarks=10, dmin=5e1, dmax=1e4, spd_repair=False,
              motion_noise=(1e-6, 1e-6, 1e-6), measurement_noise=(1e-6, 1e-6))
ATOL = 1e-4
NEAR_TIE_ULPS = 16       # the rule of tests/test_torch_waypoint_loop.py


def _f32(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def _tie_ulps(cfg, u, pose_xyt, wpt, noise_nkc):
    """Per horizon step: the gap between the two smallest float64
    cost-to-go values of the tick, in float32 ulps at their magnitude."""
    d = torch.float64
    loss, _ = rollout_losses(cfg, MODEL, pose_xyt.to(d),
                             u.to(d)[None] + noise_nkc.transpose(0, 1).to(d),
                             wpt.to(d))
    two = torch.topk(cost_to_go(loss), 2, dim=1, largest=False).values
    gap = (two[:, 1] - two[:, 0]).numpy()
    return gap / np.spacing(two[:, 0].numpy().astype(np.float32))


def _numpy_state(jst):
    d = {name: np.asarray(getattr(jst, name)) for name in
         ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks", "done")}
    d["ekf"] = {name: np.asarray(getattr(jst.ekf, name))
                for name in jst.ekf._fields}
    return d


@pytest.mark.parametrize("known_da", [True, False])
@pytest.mark.parametrize("use_fused", [False, True])
def test_slam_loop_ticks_match_tpunav(use_fused, known_da):
    jcfg = jm.MPPIConfig(**MPPI_KW)
    jekf = JEKFConfig(**EKF_KW)
    jloop = jsl.SlamLoopConfig(goal_thresh=0.12, known_da=known_da,
                               sensor_every=3)
    jmodel = JCartParams(0.033, 0.160)
    jw = jnp.asarray(WAYPOINTS, jnp.float32)
    jl = jnp.asarray(LANDMARKS, jnp.float32)
    jst = jsl.slam_loop_init(jcfg, jekf, seed=1)
    jtick = jax.jit(lambda s: jsl.slam_loop_tick(jcfg, jekf, jloop, jmodel,
                                                 jw, jl, s))

    cfg = interop.config_from_fields(MPPIConfig, dataclasses.asdict(jcfg))
    ekf_cfg = interop.config_from_fields(tf.EKFConfig,
                                         dataclasses.asdict(jekf))
    loop = dataclasses.replace(
        interop.config_from_fields(SlamLoopConfig, dataclasses.asdict(jloop)),
        use_fused=use_fused)
    waypoints, landmarks = _f32(WAYPOINTS), _f32(LANDMARKS)

    exempt, max_d = 0, 0.0
    for tick in range(30):
        st = interop.slam_loop_state_from_numpy(_numpy_state(jst),
                                                device="cpu")
        _, k_solve, k_meas, _ = jax.random.split(jst.key, 4)
        noise = torch.from_numpy(np.asarray(jm.sample_perturbations(
            jcfg, k_solve, dtype=jnp.float32)).transpose(1, 0, 2).copy())
        meas_noise = torch.from_numpy(np.array(jax.random.normal(
            k_meas, (len(LANDMARKS), 2), jnp.float32)))
        jst = jtick(jst)
        pre = st
        st = slam_loop_tick(cfg, ekf_cfg, loop, MODEL, waypoints, landmarks,
                            st, noise=noise, meas_noise=meas_noise)
        got, want = interop.slam_loop_state_to_numpy(st), _numpy_state(jst)
        for name in ("wpt_idx", "visits", "ticks", "done"):
            assert int(got[name]) == int(want[name]), (tick, name)
        assert int(got["ekf"]["count"]) == int(want["ekf"]["count"]), tick
        np.testing.assert_array_equal(got["ekf"]["active"],
                                      want["ekf"]["active"])
        for name, g, w in [("true_pose", got["true_pose"],
                            want["true_pose"]),
                           ("ekf pose", got["ekf"]["state"][:3],
                            want["ekf"]["state"][:3]),
                           ("odom", got["odom"], want["odom"])]:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg=f"tick {tick}: {name}")
            max_d = max(max_d, float(np.abs(g - w).max()))
        du = np.abs(got["u"] - want["u"]).max(axis=1)
        bad = np.nonzero(du > ATOL)[0]
        if len(bad):
            est = pre.ekf.state[:3]
            pose_xyt = torch.stack([est[1], est[2], est[0]])
            gaps = _tie_ulps(cfg, pre.u, pose_xyt,
                             waypoints[int(got["wpt_idx"])], noise)
        for r in bad:
            # u_next row r is update row r + 1 (the receding shift).
            assert gaps[r + 1] < NEAR_TIE_ULPS, (tick, r, gaps[r + 1])
            exempt += 1
    assert exempt <= 2
    assert max_d < ATOL
    assert int(st.ekf.count) >= 3                     # the filter mapped
    assert np.abs(got["true_pose"]).max() > 1e-3      # the cart moved


def test_sensor_runs_on_schedule_only():
    """``meas_fn`` is called on ticks 0, k, 2k, ... and nowhere else."""
    cfg = MPPIConfig(**MPPI_KW)
    ekf_cfg = tf.EKFConfig(**{**EKF_KW, "num_landmarks": 12})
    loop = SlamLoopConfig(sensor_every=4, known_da=False)
    st = slam_loop_init(cfg, ekf_cfg, seed=0, device="cpu")
    calls = []

    def meas_fn(true_txy, generator):
        calls.append(st_box[0].host_ticks)
        return torch.full((3, 2), float("nan"))

    st_box = [st]
    for _ in range(10):
        st_box[0] = slam_loop_tick(cfg, ekf_cfg, loop, MODEL,
                                   _f32(WAYPOINTS), _f32(LANDMARKS),
                                   st_box[0], meas_fn=meas_fn)
    assert calls == [0, 4, 8]
    assert st_box[0].host_ticks == int(st_box[0].ticks) == 10


def test_state_round_trip():
    cfg = MPPIConfig(**MPPI_KW)
    st = slam_loop_init(cfg, tf.EKFConfig(**EKF_KW), pose_xyt=[0.1, 0.2, 0.3],
                        seed=4, device="cpu")
    back = interop.slam_loop_state_from_numpy(
        interop.slam_loop_state_to_numpy(st), device="cpu", seed=4)
    assert back.ekf.state.dtype == torch.float32
    for name in ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks",
                 "done"):
        assert torch.equal(getattr(back, name), getattr(st, name))
    for name in tf.EKFState._fields:
        assert torch.equal(getattr(back.ekf, name), getattr(st.ekf, name))
    want = np.float32([0.3, 0.1, 0.2])
    np.testing.assert_array_equal(st.odom.numpy(), want)
    np.testing.assert_array_equal(st.ekf.state[:3].numpy(), want)


# ----------------------------------------------- tests/test_slam_loop.py --

def _errors(st):
    est, tru, odo = st.ekf.state[:3], st.true_pose, st.odom
    ekf = float(torch.hypot(est[1] - tru[0], est[2] - tru[1]))
    return ekf, float(torch.hypot(odo[1] - tru[0], odo[2] - tru[1]))


@pytest.mark.parametrize("known_da", [True, False])
def test_run_slam_loop_completes_course(known_da):
    cfg = MPPIConfig(**MPPI_KW)
    ekf_cfg = tf.EKFConfig(**EKF_KW)
    loop = SlamLoopConfig(goal_thresh=0.12, known_da=known_da,
                          sensor_every=4)
    st = run_slam_loop(cfg, ekf_cfg, loop, MODEL, WAYPOINTS, LANDMARKS,
                       slam_loop_init(cfg, ekf_cfg, seed=1, device="cpu"),
                       max_ticks=4000)
    assert bool(st.done), f"{int(st.visits)} visits in {int(st.ticks)} ticks"
    ekf_err, odo_err = _errors(st)
    if known_da:
        assert ekf_err < 0.05 and ekf_err < odo_err
    else:
        assert ekf_err < 0.1 and int(st.ekf.count) >= 4


# ----------------------------------------- tests/test_perception_loop.py --

BLOCK = [[0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
         [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
         [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]]


@pytest.mark.parametrize("known", [True, False])
def test_lidar_to_ekf_chain(known):
    """Scans of 12 cylinders → the circle detector → the EKF, 300 updates
    with biased odometry, float32 (tests/test_perception_loop.py:39-99):
    known DA through the id oracle, and unknown DA at config 4's capacity
    50."""
    if known:
        cfg = tf.EKFConfig(num_landmarks=12, spd_repair=False,
                           motion_noise=(1e-6,) * 3,
                           measurement_noise=(1e-5, 1e-5))
    else:      # BASELINE config 4's filter: unknown DA at capacity 50
        cfg = tf.EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                           spd_repair=False, motion_noise=(1e-5,) * 3,
                           measurement_noise=(1e-5, 1e-5))
    lm_cfg = tl.LandmarkConfig(max_clusters=16)
    step = tf.known_correspondence_slam if known else tf.slam_unknown_da
    lms = _f32(BLOCK)
    radii = torch.full((12,), 0.04)
    u_true, u_odom = _f32([0.03, 0.015]), _f32([0.031, 0.0155])
    gen = torch.Generator().manual_seed(0)
    zero = torch.zeros(3)
    pose, odom = torch.zeros(3), torch.zeros(3)
    st = tf.ekf_init(cfg, torch.float32, device="cpu")
    for _ in range(300):
        pose = tf.motion_update(cfg, pose, u_true, zero)
        odom = tf.motion_update(cfg, odom, u_odom, zero)
        ranges = scan_cylinders(pose, lms, radii, generator=gen,
                                noise_std=1e-3)
        meas = tl.circles_to_measurements(tl.feature_detection(lm_cfg,
                                                               ranges))
        if known:
            meas = associate_known(meas, lms, pose)
        st = step(cfg, st, meas, u_odom)
    slam, odo = (tf.robot_pose(st) - pose).numpy(), (odom - pose).numpy()
    assert np.linalg.norm(slam[1:]) < 0.05 and abs(slam[0]) < 0.05
    assert np.linalg.norm(slam[1:]) < 0.25 * np.linalg.norm(odo[1:])
    if known:
        assert abs(slam[0]) < 0.25 * abs(odo[0]) and int(st.count) >= 10
    else:
        assert 8 <= int(st.count) <= 16


def test_dense_world_closed_loop_smoke():
    """Config 4 shrunk for CI as tests/test_perception_loop.py:129-145
    shrinks it (600 ticks, K=256): the 44-cylinder world, the 12-waypoint
    ring, every measurement through lidar → detector → unknown-DA EKF at
    capacity 50, MPPI through K1's plain version off the filter's pose."""
    ao = np.linspace(0.0, 2 * np.pi, 24, endpoint=False)
    ai = np.linspace(0.0, 2 * np.pi, 20, endpoint=False) + 0.13
    world = _f32(np.concatenate([
        np.stack([1.55 * np.cos(ao), 1.55 * np.sin(ao)], -1),
        np.stack([0.95 * np.cos(ai), 0.95 * np.sin(ai)], -1)]))
    a = np.linspace(0.0, 2 * np.pi, 12, endpoint=False)
    r = np.where(np.arange(12) % 2 == 0, 1.42, 1.12)
    ring = _f32(np.stack([r * np.cos(a), r * np.sin(a), a + np.pi / 2], -1))
    radii = torch.full((44,), 0.04)
    lm_cfg = tl.LandmarkConfig(max_clusters=32)
    cfg = MPPIConfig(horizon=0.4, dt=0.05, rollouts=256, ul_var=4.0,
                     ur_var=4.0)
    ekf_cfg = tf.EKFConfig(num_landmarks=50, dmin=5e1, dmax=3e3,
                           spd_repair=False, motion_noise=(1e-5,) * 3,
                           measurement_noise=(1e-5, 1e-5))
    loop = SlamLoopConfig(goal_thresh=0.15, cycles=2, sensor_every=4,
                          tick_dt=0.05, odom_bias=(1e-4, 1e-4),
                          known_da=False, use_fused=True)

    def meas_fn(true_txy, generator):
        ranges = scan_cylinders(true_txy, world, radii, generator=generator,
                                noise_std=1e-3)
        return tl.circles_to_measurements(tl.feature_detection(lm_cfg,
                                                               ranges))

    st = slam_loop_init(cfg, ekf_cfg, pose_xyt=[1.42, 0.0, math.pi / 2],
                        seed=0, device="cpu")
    for _ in range(600):
        st = slam_loop_tick(cfg, ekf_cfg, loop, MODEL, ring, world, st,
                            meas_fn=meas_fn)
    est, tru = st.ekf.state[:3], st.true_pose
    slam_xy = float(torch.hypot(est[1] - tru[0], est[2] - tru[1]))
    odo_xy = float(torch.hypot(st.odom[1] - tru[0], st.odom[2] - tru[1]))
    assert int(st.ekf.count) >= 10
    assert slam_xy < 0.15 and slam_xy < 0.5 * odo_xy, (slam_xy, odo_xy)
    heading = float(normalize_angle_pi(est[0] - tru[2]))
    assert math.isfinite(heading)


# ------------------------------------- the plain backend's replayed chunks --

def _plain_c3(known):
    """Config 3's loop on the plain backend, shrunk: K=64, sensing every 4
    ticks, a two-waypoint course done in ~80 ticks."""
    cfg = MPPIConfig(**dict(MPPI_KW, rollouts=64))
    ekf_cfg = tf.EKFConfig(**EKF_KW)
    loop = SlamLoopConfig(goal_thresh=0.05, known_da=known, sensor_every=4,
                          meas_noise_std=1e-3)
    wpts = torch.tensor([[0.12, 0.0, 0.0], [0.12, 0.1, 1.57]])
    return cfg, ekf_cfg, loop, wpts, torch.tensor(LANDMARKS)


def _plain_eager(cfg, ekf_cfg, loop, wpts, lms, st, max_ticks, row=None):
    rows = []
    while st.host_ticks < max_ticks and not (row is None and bool(st.done)):
        st = slam_loop_tick(cfg, ekf_cfg, loop, MODEL, wpts, lms, st)
        if row is not None:
            rows.append(row(st))
    return st, rows


def _assert_loop_state(got, want):
    assert got.host_ticks == want.host_ticks
    for f in ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks",
              "done"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for name, x, y in zip(tf.EKFState._fields, got.ekf, want.ekf):
        assert torch.equal(x, y), name
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("max_ticks,chunk,lead", [(600, 24, 0),
                                                  (50, 12, 3)])
def test_plain_run_slam_loop_equals_eager_ticks(known, max_ticks, chunk,
                                                lead):
    """``run_slam_loop`` on the plain backend: held chunks stopping
    mid-chunk on done (chunks of 24) or on ``max_ticks`` (50, from a state
    3 ticks in, off the sensing schedule), in the eager per-tick loop's
    state and generator."""
    cfg, ekf_cfg, loop, wpts, lms = _plain_c3(known)

    def start():
        st = slam_loop_init(cfg, ekf_cfg, seed=1, device="cpu")
        return _plain_eager(cfg, ekf_cfg, loop, wpts, lms, st, lead)[0]

    want, _ = _plain_eager(cfg, ekf_cfg, loop, wpts, lms, start(), max_ticks)
    assert bool(want.done) == (max_ticks == 600)
    assert (want.host_ticks - lead) % chunk
    got = run_slam_loop(cfg, ekf_cfg, loop, MODEL, wpts, lms, start(),
                        max_ticks=max_ticks, chunk=chunk)
    _assert_loop_state(got, want)


def test_plain_run_slam_course_equals_eager_ticks():
    """``run_slam_course`` on the plain backend: 70 ticks from a state 3
    ticks in (eager to the sensing tick, two chunks of 24, a last one of
    19), with a telemetry row per tick, the eager per-tick
    loop's rows, state and generator."""
    cfg, ekf_cfg, loop, wpts, lms = _plain_c3(False)

    def row(st):
        return torch.cat([st.ekf.state[:3], st.true_pose,
                          st.ekf.count.to(torch.float32)[None]])

    def start():
        st = slam_loop_init(cfg, ekf_cfg, seed=2, device="cpu")
        return _plain_eager(cfg, ekf_cfg, loop, wpts, lms, st, 3)[0]

    want, rows = _plain_eager(cfg, ekf_cfg, loop, wpts, lms, start(), 73,
                              row)
    got, got_rows = run_slam_course(cfg, ekf_cfg, loop, MODEL, wpts, lms,
                                    start(), 70, telemetry=row, chunk=24)
    _assert_loop_state(got, want)
    assert torch.equal(got_rows, torch.stack(rows))
