"""The port's loops as CUDA graphs (``tpunav_torch/capture.py``), on the
CPU path that the card replays: the same bodies on the same static
buffers, without capture.

- The MPPI course on the fused backend (on the CPU K1's plain version,
  which replays the in-kernel Philox stream): ``run_course`` equals the
  eager per-tick loop in every field, bit for bit, for chunks of 1, 7 and
  one that does not divide the course, and at ``max_ticks``;
  ``run_course_chunked`` equals the eager chunked loop (ticks, telemetry
  rows, copies that later chunks leave alone); both also with K1's
  obstacle mode.
- The RBPF stepper over 8 updates equals a chain of ``pf_slam_step`` bit
  for bit; with ``tpunav``'s normals injected it equals ``tpunav``'s
  ``pf_slam_step`` at the bars of tests/test_torch_rbpf.py.
- The masked EKF update against the dynamic one, bit for bit, and against
  ``tpunav``'s update at float64 1e-9: both DAs, M = 0, all-NaN rows, all
  rows valid, unknown DA at capacity, and the where-form SPD repair. The
  EKF stepper equals the dynamic update's chain.
- Config 3's slam loop, shrunk, under the graph path equals the eager
  ``run_slam_loop`` bit for bit, the generator's state included: to done,
  at ``max_ticks``, and from a tick off the sensing schedule.
- The repairs that make the bodies capturable: each configuration's
  constants are built once, and a launch counter advances by the captured
  change per replay.
- The paths this package's eigensolver kernel (``ops/sym_eig.py``) brought
  under graphs: the EKF stepper with the default SPD repair (once per
  update and per row) against the eager masked update, bit for bit, and
  ``tpunav``'s at float64 1e-9, from a covariance the repair must fix;
  config 4's chunked course (``run_slam_course``: lidar → detector →
  unknown DA, scan semantics, telemetry) against the eager per-tick
  course, generator included; the landmarks node's replayed detector
  against the eager detector. K1's hold flag is a no-op on its plain
  version.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples_torch import dense_world_slam_demo as c4
from examples_torch import slam_mppi_closed_loop_demo as c3
from tpunav.estimation.ekf import filter as jf
from tpunav.estimation.rbpf import PFConfig as JPFConfig
from tpunav.estimation.rbpf import grid as jg
from tpunav.estimation.rbpf import icp as jicp
from tpunav.estimation.rbpf import particle_filter as jpf
from tpunav_torch import capture, device, interop
from tpunav_torch.control import mppi
from tpunav_torch.control import slam_loop as sl
from tpunav_torch.control.obstacle_cost import (SegmentCostParams,
                                                segments_from_polygons)
from tpunav_torch.control.waypoint_loop import (CourseConfig, course_init,
                                                course_tick, run_course,
                                                run_course_chunked)
from tpunav_torch.estimation import landmarks as tl
from tpunav_torch.estimation.ekf import filter as tf
from tpunav_torch.estimation.ekf import spd
from tpunav_torch.estimation.rbpf import grid as tg
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.models.cart import CartParams
from tpunav_torch.ops import (ekf_rows, fused_mppi, icp, likelihood, map_update,
                              sym_eig)
from tpunav_torch.sim import lidar as tlidar

torch.set_num_threads(1)

F32 = jnp.float32
MODEL = CartParams(0.033, 0.160)

# ------------------------------------------------------------ the course --

# A short course (~140 ticks) at a small width: K=32, N=10.
CFG = mppi.MPPIConfig(horizon=0.2, dt=0.02, rollouts=32, ul_var=4.0,
                      ur_var=4.0)
COURSE = torch.tensor([[0.08, 0.0, 0.0], [0.08, 0.06, 1.57],
                       [0.0, 0.05, 3.14]])
# A wall above the course, priced by K1's obstacle mode (it moves the
# course: done in 141 ticks, not 139).
WALL = dict(obstacles=segments_from_polygons(
    [[[-0.1, 0.11], [0.2, 0.11], [0.2, 0.13], [-0.1, 0.13]]], device="cpu"),
    obs_cfg=SegmentCostParams(r_safe=0.02, w_hit=1e6, w_field=1e2,
                              sigma=0.02))
FIELDS = ("pose", "u", "wpt_idx", "visits", "ticks", "done", "wheel_vel")


def _course(max_ticks=400):
    return CourseConfig(goal_thresh=0.03, use_fused=True, fused_seed=3,
                        max_ticks=max_ticks)


def _start():
    return course_init(CFG, torch.zeros(3), device="cpu")


def _eager(course, obstacles):
    """The eager per-tick loop: ticks until done or max_ticks."""
    kw = WALL if obstacles else {}
    st = _start()
    while int(st.ticks) < course.max_ticks and not bool(st.done):
        st = course_tick(CFG, course, MODEL, COURSE, st, **kw)
    return st


def _eager_chunked(course, obstacles, chunk):
    """The eager chunked loop: chunks of ticks past done, with pre-tick
    telemetry rows."""
    kw = WALL if obstacles else {}
    st, chunks = _start(), []
    while True:
        rows = {"pose": [], "wpt_idx": [], "d2g": []}
        for _ in range(chunk):
            wpt = COURSE[int(st.wpt_idx)]
            rows["pose"].append(st.pose)
            rows["wpt_idx"].append(st.wpt_idx)
            rows["d2g"].append(torch.hypot(st.pose[0] - wpt[0],
                                           st.pose[1] - wpt[1]))
            st = course_tick(CFG, course, MODEL, COURSE, st, **kw)
        chunks.append((st, {k: torch.stack(v) for k, v in rows.items()}))
        if bool(st.done) or int(st.ticks) >= course.max_ticks:
            return chunks


@pytest.fixture(scope="module")
def eager_runs():
    return {(obst, max_ticks): _eager(_course(max_ticks), obst)
            for obst in (False, True) for max_ticks in (400, 60)}


def _assert_state(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("obstacles", [False, True])
@pytest.mark.parametrize("chunk,max_ticks", [(1, 400), (7, 400), (50, 400),
                                             (7, 60)])
def test_run_course_equals_eager_ticks(eager_runs, obstacles, chunk,
                                       max_ticks):
    """The held-tick chunks end in the eager loop's state, every field bit
    for bit, whether the course ends done (~140 ticks, past the last full
    chunk of 7 and of 50) or at max_ticks."""
    want = eager_runs[(obstacles, max_ticks)]
    assert bool(want.done) == (max_ticks == 400)
    got = run_course(CFG, _course(max_ticks), MODEL, COURSE, _start(),
                     chunk=chunk, **(WALL if obstacles else {}))
    _assert_state(got, want)


@pytest.mark.parametrize("obstacles", [False, True])
def test_run_course_chunked_equals_eager_chunks(obstacles):
    """The graph path's chunks are tpunav's scan: ticks past done to the
    chunk's end, the eager chunked loop's state and telemetry rows, and
    the copies handed to on_chunk keep their values after later chunks."""
    chunk, course = 50, _course()
    want = _eager_chunked(course, obstacles, chunk)
    seen = []
    got = run_course_chunked(CFG, course, MODEL, COURSE, _start(),
                             chunk=chunk, on_chunk=lambda s, t: seen.append(
                                 (s, t)), **(WALL if obstacles else {}))
    assert len(seen) == len(want) >= 3
    assert int(got.ticks) % chunk == 0 and bool(got.done)
    _assert_state(got, want[-1][0])
    for (s, tel), (ws, wtel) in zip(seen, want):
        _assert_state(s, ws)
        for name in ("pose", "wpt_idx", "d2g"):
            assert torch.equal(tel[name], wtel[name]), name


def test_run_course_of_a_finished_state_is_that_state():
    st = _eager(_course(), False)
    assert run_course(CFG, _course(), MODEL, COURSE, st) is st


# ------------------------------------------------------------- the RBPF --

SMALL = dict(resolution=0.1, num_beams=90, beam_delta=2 * math.pi / 90)


def _pf_cfgs(p=4, k=6, max_iter=15):
    kw = dict(num_particles=p, k_samples=k, sample_range=(1e-6, 1e-5, 1e-5),
              motion_noise=(1e-6, 1e-5, 1e-5))
    jcfg = JPFConfig(grid=jg.GridConfig(**SMALL),
                     icp=jicp.ICPConfig(max_iter=max_iter), **kw)
    tcfg = interop.config_from_fields(tpf.PFConfig, dataclasses.asdict(jcfg))
    return jcfg, tcfg


def _scans(cfg, n):
    """A box-world arc: (scan, u, odom, previous odom) per update."""
    segs = tlidar.box_segments(-1.5, -1.5, 1.5, 1.5, device="cpu")
    u = torch.tensor([0.02, 0.01])
    pose = prev = torch.zeros(3)
    out = []
    for _ in range(n):
        th = pose[0] + u[0]
        pose = torch.stack([th, pose[1] + u[1] * torch.cos(th),
                            pose[2] + u[1] * torch.sin(th)])
        scan = tlidar.scan_segments(pose, segs, num_beams=cfg.grid.num_beams,
                                    beam_delta=cfg.grid.beam_delta,
                                    max_range=cfg.grid.range_max,
                                    generator=torch.Generator().manual_seed(
                                        len(out)), noise_std=0.005)
        out.append((scan, u, pose, prev))
        prev = pose
    return out


def test_pf_stepper_equals_the_eager_chain():
    """8 updates through the stepper (its normals drawn from the shared
    generator before each replay) and 8 of pf_slam_step: every leaf and the
    generator's state bit for bit."""
    _, cfg = _pf_cfgs()
    inputs = _scans(cfg, 8)
    st = tpf.pf_init(cfg, seed=1, device="cpu")
    for x in inputs:
        st = tpf.pf_slam_step(cfg, st, *x)
    stepper = tpf.PFStepper(cfg, tpf.pf_init(cfg, seed=1, device="cpu"),
                            device="cpu")
    for x in inputs:
        got = stepper.step(*x)
    assert got is stepper.state                   # the state lives in place
    for name, a, b in zip(tpf.PFState._fields, got[:-1], st[:-1]):
        assert torch.equal(a, b), name
    assert torch.equal(got.generator.get_state(), st.generator.get_state())
    assert float(torch.logsumexp(got.log_weights, 0)) == pytest.approx(0.0,
                                                                      abs=1e-5)


def _jax_noise(jcfg, key):
    """The normals tpunav's pf_slam_step draws from ``key`` (as
    tests/test_torch_rbpf.py replays them)."""
    p, k = jcfg.num_particles, jcfg.k_samples
    _, _, k_particles, k_res = jax.random.split(key, 4)
    samples, pose, motion = [], [], []
    for pk in jax.random.split(k_particles, p):
        k1, k2 = jax.random.split(pk)
        samples.append(jax.random.normal(k1, (k, 3), F32))
        pose.append(jax.random.normal(k2, (3,), F32))
        motion.append(jax.random.normal(pk, (3,), F32))
    t = lambda a: torch.from_numpy(np.array(a))
    return tpf.PFNoise(samples=t(np.stack(samples)), pose=t(np.stack(pose)),
                       motion=t(np.stack(motion)),
                       resample=t(jax.random.normal(k_res, (), F32)))


_PF_STATE = ("poses", "prev_poses", "log_weights", "grids", "dists",
             "prev_scan", "has_prev")


def test_pf_stepper_with_tpunav_normals_matches_tpunav():
    """Three updates from tpunav's mapped state, tpunav's normals handed to
    the stepper: the bars of tests/test_torch_rbpf.py after each."""
    jcfg, tcfg = _pf_cfgs()
    inputs = _scans(tcfg, 3)
    st0 = jpf.pf_init(jcfg, seed=3)
    scan0 = jnp.asarray(inputs[0][0].numpy())
    grids = jax.vmap(lambda g: jg.integrate_scan(jcfg.grid, g, scan0,
                                                 jnp.zeros(3, F32)))(
        st0.grids)
    jst = st0._replace(grids=grids, prev_scan=scan0,
                       dists=jax.vmap(lambda g: jg.esdf(jcfg.grid, g))(grids),
                       has_prev=jnp.asarray(True))
    stepper = tpf.PFStepper(tcfg, interop.pf_state_from_numpy(
        {name: np.asarray(getattr(jst, name)) for name in _PF_STATE},
        device="cpu"), device="cpu")
    step = jax.jit(lambda s, scan, u, od, pv: jpf.pf_slam_step(
        jcfg, s, scan, u, od, pv, backend="xla"))
    for x in inputs:
        noise = _jax_noise(jcfg, jst.key)
        jst = step(jst, *(jnp.asarray(v.numpy()) for v in x))
        got = interop.pf_state_to_numpy(stepper.step(*x, noise=noise))
        np.testing.assert_allclose(got["poses"], np.asarray(jst.poses),
                                   atol=1e-3)
        np.testing.assert_allclose(got["log_weights"],
                                   np.asarray(jst.log_weights), atol=0.05)
        for name in ("grids", "dists"):
            np.testing.assert_allclose(got[name],
                                       np.asarray(getattr(jst, name)),
                                       atol=1e-3)
        np.testing.assert_array_equal(got["prev_scan"], x[0].numpy())


# -------------------------------------------------------------- the EKF --

def _ekf_course(n_lm, rows, vis, u=(0.02, 0.012), steps=6, seed=5,
                nan_rows=()):
    """Robot-frame measurements of ``n_lm`` landmarks on an arc, ``rows``
    rows per update (the landmarks first, NaN padding after), NaN beyond
    ``vis`` and in ``nan_rows``, 1 mm noise."""
    rng = np.random.default_rng(seed)
    lms = rng.uniform(-1.0, 1.0, (n_lm, 2))
    pose, out = np.zeros(3), []
    for _ in range(steps):
        pose = np.array([pose[0] + u[0],
                         pose[1] + u[1] * np.cos(pose[0] + u[0]),
                         pose[2] + u[1] * np.sin(pose[0] + u[0])])
        c, s = np.cos(pose[0]), np.sin(pose[0])
        rel = lms - pose[1:3]
        rf = np.stack([c * rel[:, 0] + s * rel[:, 1],
                       -s * rel[:, 0] + c * rel[:, 1]], -1)
        rf = rf + rng.normal(0, 1e-3, rf.shape)
        rf[np.linalg.norm(rel, axis=1) >= vis] = np.nan
        m = np.full((rows, 2), np.nan)
        m[:n_lm] = rf
        m[list(nan_rows)] = np.nan
        out.append(m)
    return out


EKF_KW = dict(spd_repair=False, motion_noise=(1e-6, 1e-6, 1e-6),
              measurement_noise=(1e-5, 1e-5), dmin=5e1, dmax=1e4)
# name: (config, measurements per update). The mixed course, M = 0, rows
# that are all NaN, every row valid, the SPD repair in its where form, and
# (unknown DA) more landmarks than slots.
EKF_CASES = {
    "mixed": (dict(num_landmarks=8, **EKF_KW),
              lambda: _ekf_course(6, 8, 1.1, nan_rows=(2,))),
    "m0": (dict(num_landmarks=6, **EKF_KW),
           lambda: [np.zeros((0, 2))] * 3),
    "all_nan": (dict(num_landmarks=6, **EKF_KW),
                lambda: [np.full((6, 2), np.nan)] * 3),
    "all_valid": (dict(num_landmarks=5, **EKF_KW),
                  lambda: _ekf_course(5, 5, 10.0)),
    "spd_repair": (dict(EKF_KW, num_landmarks=6, spd_repair=True,
                        spd_repair_per_meas=True),
                   lambda: _ekf_course(5, 6, 10.0, steps=3)),
    "capacity": (dict(num_landmarks=3, **EKF_KW),
                 lambda: _ekf_course(6, 6, 10.0)),
}


def _ekf_pair(known):
    if known:
        return (tf.known_correspondence_slam,
                tf.known_correspondence_slam_masked,
                jf.known_correspondence_slam)
    return tf.slam_unknown_da, tf.slam_unknown_da_masked, jf.slam_unknown_da


@pytest.mark.parametrize("known,case", [
    (known, case) for known in (True, False) for case in sorted(EKF_CASES)
    # Known DA takes at most one row per slot: it has no capacity case.
    if not (known and case == "capacity")])
def test_masked_update_equals_dynamic_and_tpunav(known, case):
    """The masked form gives the dynamic form's bits in float64 and
    float32, and tpunav's float64 update within 1e-9."""
    kw, course = EKF_CASES[case]
    dynamic, masked, theirs = _ekf_pair(known)
    jcfg, cfg = jf.EKFConfig(**kw), tf.EKFConfig(**kw)
    jstep = jax.jit(lambda s, m, u: theirs(jcfg, s, m, u))
    u = (0.02, 0.012)
    for dtype in (torch.float64, torch.float32):
        a = b = tf.ekf_init(cfg, dtype=dtype, device="cpu")
        jst = jf.ekf_init(jcfg)
        for meas in course():
            m = torch.as_tensor(meas, dtype=dtype)
            ut = torch.tensor(u, dtype=dtype)
            a, b = dynamic(cfg, a, m, ut), masked(cfg, b, m, ut)
            for name, x, y in zip(tf.EKFState._fields, a, b):
                assert torch.equal(x, y), (dtype, name)
            if dtype == torch.float64:
                # tpunav takes no M = 0: its prediction alone is one NaN row.
                jst = jstep(jst, jnp.asarray(meas if len(meas) else
                                             np.full((1, 2), np.nan)),
                            jnp.asarray(u))
                np.testing.assert_allclose(b.state.numpy(),
                                           np.asarray(jst.state), atol=1e-9)
                np.testing.assert_allclose(b.cov.numpy(), np.asarray(jst.cov),
                                           atol=1e-9)
                np.testing.assert_array_equal(b.active.numpy(),
                                              np.asarray(jst.active))
                assert int(b.count) == int(jst.count)
    if case == "capacity":
        assert int(b.count) == cfg.num_landmarks


@pytest.mark.parametrize("known", [True, False])
def test_ekf_stepper_equals_the_dynamic_chain(known):
    kw, course = EKF_CASES["mixed"]
    cfg = tf.EKFConfig(**kw)
    dynamic = _ekf_pair(known)[0]
    u = torch.tensor([0.02, 0.012], dtype=torch.float32)
    st = tf.ekf_init(cfg, dtype=torch.float32, device="cpu")
    stepper = tf.EKFStepper(cfg, st, 8, known, device="cpu")
    for meas in course():
        m = torch.as_tensor(meas, dtype=torch.float32)
        st = dynamic(cfg, st, m, u)
        got = stepper.step(m, u)
    for name, x, y in zip(tf.EKFState._fields, got, st):
        assert torch.equal(x, y), name


def test_steppers_take_a_state_on_their_device():
    """A stepper's buffers lie on its device (the card by default), where
    its state must lie; the EKF stepper takes the default SPD repair."""
    cfg = tf.EKFConfig(num_landmarks=4)            # spd_repair=True
    st = tf.ekf_init(cfg, device="cpu")
    stepper = tf.EKFStepper(cfg, st, 4, device="cpu")
    assert stepper.state.cov.device.type == "cpu"
    with pytest.raises(ValueError, match="lies on cpu"):
        tf.EKFStepper(cfg, st, 4, device="meta")
    _, pcfg = _pf_cfgs()
    with pytest.raises(ValueError, match="lies on cpu"):
        tpf.PFStepper(pcfg, tpf.pf_init(pcfg, device="cpu"), device="meta")


# -------------------------------------------------------- the slam loop --

def _c3(known, max_ticks=None):
    """Config 3 shrunk: K=64 and a two-waypoint course done in ~80 ticks."""
    m, e, loop = c3.configs(known, 12, use_fused=True, rollouts=64)
    loop = dataclasses.replace(loop, goal_thresh=0.05)
    wpts = torch.tensor([[0.12, 0.0, 0.0], [0.12, 0.1, 1.57]])
    lms = torch.as_tensor(np.asarray(c3.block_world()), dtype=torch.float32)
    return m, e, loop, wpts, lms


def _slam_eager(m, e, loop, wpts, lms, st, max_ticks):
    while st.host_ticks < max_ticks and not bool(st.done):
        st = sl.slam_loop_tick(m, e, loop, c3.MODEL, wpts, lms, st)
    return st


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("max_ticks,chunk,lead", [(600, None, 0),
                                                  (50, 12, 0),
                                                  (600, 18, 4)])
def test_run_slam_loop_graph_equals_eager(known, max_ticks, chunk, lead):
    """Chunks of held ticks with the masked update end in the eager loop's
    state, bit for bit, the generator's included: to done (a 60-tick chunk
    past it), at max_ticks (50, mid-chunk), and from a state ``lead``
    ticks in, off the sensing schedule."""
    m, e, loop, wpts, lms = _c3(known)
    start = sl.slam_loop_init(m, e, seed=1, device="cpu")
    start = _slam_eager(m, e, loop, wpts, lms, start, lead)
    want = _slam_eager(m, e, loop, wpts, lms, start, max_ticks)
    start = sl.slam_loop_init(m, e, seed=1, device="cpu")
    start = _slam_eager(m, e, loop, wpts, lms, start, lead)
    got = sl.run_slam_loop(m, e, loop, c3.MODEL, wpts, lms, start,
                           max_ticks=max_ticks, chunk=chunk)
    assert bool(want.done) == (max_ticks == 600)
    assert got.host_ticks == want.host_ticks
    for f in ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks",
              "done"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for name, x, y in zip(tf.EKFState._fields, got.ekf, want.ekf):
        assert torch.equal(x, y), name
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_run_slam_loop_chunk_must_hold_whole_sensing_periods():
    m, e, loop, wpts, lms = _c3(True)
    st = sl.slam_loop_init(m, e, seed=1, device="cpu")
    with pytest.raises(ValueError, match="multiple of sensor_every"):
        sl.run_slam_loop(m, e, loop, c3.MODEL, wpts, lms, st, max_ticks=10,
                         chunk=loop.sensor_every + 1)


# ----------------------------------------------------------- the repairs --

def _constant_sites():
    """Each step's configuration constants, by the function that returns
    them."""
    like = torch.zeros(3)
    pcfg = tpf.PFConfig()
    ecfg = tf.EKFConfig(num_landmarks=3)
    return {
        "control.mppi._const": lambda: mppi._const(CFG.q_diag, torch.float32,
                                                   like.device),
        "particle_filter._std": lambda: tpf._std(pcfg.sample_range, like),
        "device.constant": lambda: device.constant(0.05, torch.float32,
                                                   like.device),
        "ekf.filter._const": lambda: tf._const(ecfg.motion_noise, like),
        "ekf.filter._update_consts": lambda: tf._update_consts(ecfg,
                                                               like).eye,
    }


@pytest.mark.parametrize("site", sorted(_constant_sites()))
def test_configuration_constants_are_built_once(site):
    fn = _constant_sites()[site]
    assert fn() is fn()


def test_grid_update_takes_its_constants_once():
    """integrate_scan's constants come from the cache: a second call adds
    no entry, and its result is unchanged."""
    cfg = tg.GridConfig(**SMALL)
    scan = torch.full((cfg.num_beams,), 1.0)
    grid = tg.grid_init(cfg, device="cpu")
    a = tg.integrate_scan(cfg, grid, scan, torch.zeros(3))
    size = device.constant.cache_info().currsize
    b = tg.integrate_scan(cfg, grid, scan, torch.zeros(3))
    assert device.constant.cache_info().currsize == size
    assert torch.equal(a, b)


def test_counters_advance_by_the_captured_change_per_replay(monkeypatch):
    """What a capture does with the launch counters, on the CPU: the body's
    change is recorded and taken back (nothing ran), and each replay adds
    it. A fake body stands for a capture, three calls for three replays."""
    for mod, attr in [(fused_mppi, "KERNEL_LAUNCHES"),
                      (fused_mppi, "OBSTACLE_LAUNCHES"),
                      (likelihood, "LIK_LAUNCHES"),
                      (map_update, "MAP_LAUNCHES"),
                      (map_update, "EDT_LAUNCHES"),
                      (sym_eig, "EIG_LAUNCHES"),
                      (icp, "ICP_LAUNCHES"),
                      (ekf_rows, "EKF_LAUNCHES")]:
        monkeypatch.setattr(mod, attr, 10)

    def body():
        fused_mppi.KERNEL_LAUNCHES += 2
        likelihood.LIK_LAUNCHES += 1
        map_update.MAP_LAUNCHES += 1
        sym_eig.EIG_LAUNCHES += 2
        icp.ICP_LAUNCHES += 1
        ekf_rows.EKF_LAUNCHES += 3

    deltas = capture.counted(body)
    assert deltas == {"K1": 2, "K1_obstacle": 0, "K2": 1, "K3": 1, "K4": 0,
                      "EIG": 2, "ICP": 1, "EKF": 3}
    assert set(capture.read_counts().values()) == {10}
    for _ in range(3):
        capture.add_counts(deltas)
    assert capture.read_counts() == {"K1": 16, "K1_obstacle": 10, "K2": 13,
                                     "K3": 13, "K4": 10, "EIG": 16, "ICP": 13,
                                     "EKF": 19}


def test_graph_runs_its_body_every_step_on_the_cpu():
    calls = []
    g = capture.Graph(lambda: calls.append(1), device="cpu")
    for _ in range(3):
        g()
    assert len(calls) == 3 and g.replays == 0 and g.deltas == {}


# ------------------------------------------- the eigensolver's new paths --

@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("per_meas", [False, True])
def test_ekf_stepper_with_the_spd_repair(known, per_meas):
    """The stepper with ``spd_repair=True`` (the default) from an
    indefinite covariance, which the first update repairs: bit for bit
    the eager masked update, and tpunav's float64 update within 1e-9."""
    kw, course = EKF_CASES["mixed"]
    kw = dict(kw, spd_repair=True, spd_repair_per_meas=per_meas)
    cfg, jcfg = tf.EKFConfig(**kw), jf.EKFConfig(**kw)
    masked, theirs = _ekf_pair(known)[1:]
    jstep = jax.jit(lambda s, m, u: theirs(jcfg, s, m, u))
    st = tf.ekf_init(cfg, device="cpu")
    cov = st.cov.clone()
    cov[0, 1] = cov[1, 0] = 1e-3
    st = st._replace(cov=cov)
    assert not bool(spd.is_spd(cov))
    jst = jf.EKFState(*(jnp.asarray(t.numpy()) for t in st))
    stepper = tf.EKFStepper(cfg, st, 8, known, device="cpu")
    u = torch.tensor([0.02, 0.012], dtype=torch.float64)
    for meas in course():
        m = torch.as_tensor(meas, dtype=torch.float64)
        st = masked(cfg, st, m, u)
        got = stepper.step(m, u)
        for name, x, y in zip(tf.EKFState._fields, got, st):
            assert torch.equal(x, y), name
        jst = jstep(jst, jnp.asarray(meas), jnp.asarray(u.numpy()))
        np.testing.assert_allclose(got.state.numpy(), np.asarray(jst.state),
                                   atol=1e-9)
        np.testing.assert_allclose(got.cov.numpy(), np.asarray(jst.cov),
                                   atol=1e-9)
        np.testing.assert_array_equal(got.active.numpy(),
                                      np.asarray(jst.active))
    assert bool(spd.is_spd(got.cov))


def _c4_eager(course, st, ticks, meas_fn, row):
    rows = []
    for _ in range(ticks):
        st = sl.slam_loop_tick(*course, st, meas_fn=meas_fn)
        rows.append(row(st))
    return st, torch.stack(rows) if rows else None


@pytest.mark.parametrize("lead,chunk,ticks", [(0, None, 130), (3, 24, 60)])
def test_config4_chunked_course_equals_eager(lead, chunk, ticks):
    """Config 4 at K=64 (the dense world, lidar → detector → unknown DA at
    capacity 50): ``run_slam_course``'s chunks, from a state ``lead``
    ticks in, with a last chunk shorter than the rest, give the eager
    per-tick loop's state, telemetry rows and generator bit for bit."""
    _, (m, e, loop), wpts, lms, meas_fn = c4.build(steps=ticks, rollouts=64,
                                                   device="cpu")
    course = (m, e, loop, c4.MODEL, wpts, lms)

    def row(st):
        return torch.cat([st.ekf.state[:3], st.true_pose,
                          st.ekf.count.to(torch.float32)[None]])

    def start():
        st = sl.slam_loop_init(m, e, pose_xyt=[1.42, 0.0, math.pi / 2],
                               seed=0, device="cpu")
        return _c4_eager(course, st, lead, meas_fn, row)[0]

    want, want_rows = _c4_eager(course, start(), ticks, meas_fn, row)
    got, rows = sl.run_slam_course(*course, start(), ticks, meas_fn=meas_fn,
                                   meas_shape=(360,), telemetry=row,
                                   chunk=chunk)
    assert got.host_ticks == want.host_ticks == lead + ticks
    for f in ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks",
              "done"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for name, x, y in zip(tf.EKFState._fields, got.ekf, want.ekf):
        assert torch.equal(x, y), name
    assert torch.equal(rows, want_rows)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    assert int(got.ekf.count) >= 3


def test_dense_world_course_chunked_equals_eager():
    """``examples_torch.dense_world_slam_demo``'s course both ways: the
    chunked (default) and the eager per-tick form agree in every output."""
    course = c4.build(steps=64, rollouts=64, device="cpu")[0]
    a, b = course(0, chunked=False), course(0)
    for key in ("ekf_err", "odo_err", "tel", "lms", "lm_active"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["count"] == b["count"] and a["visits"] == b["visits"]


def test_k1_hold_flag_is_a_no_op_on_the_plain_version():
    """The held tick's flag tells the card's K1 to return at once; its
    plain version computes the solve as usual, so the CPU bits stay."""
    u = mppi.init_controls(CFG, device="cpu") + 0.3
    args = (CFG, MODEL, u, 7, torch.tensor([0.01, 0.0, 0.1]),
            torch.tensor([0.08, 0.0, 0.0]))
    want = fused_mppi.mppi_solve_fused_packed(*args)
    for flag in (True, False):
        got = fused_mppi.mppi_solve_fused_packed(*args,
                                                 hold=torch.tensor(flag))
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="hold"):
        fused_mppi.mppi_solve_fused_packed(*args, hold=torch.tensor([1, 0]))


@pytest.mark.parametrize("turtle_map", [False, True])
def test_landmarks_node_replays_the_detector(turtle_map):
    """The landmarks node's graph step publishes the eager detector's
    measurements (and circles) bit for bit, scan after scan."""
    from tpunav_torch.runtime.channels import Channel
    from tpunav_torch.runtime.slam_nodes import LandmarksNode

    cfg = tl.LandmarkConfig(max_clusters=32)
    world = torch.from_numpy(c4.dense_world())
    radii = torch.full((world.shape[0],), c4.CYL_RADIUS)
    ch = {n: Channel(n) for n in ("scan", "landmarks", "map")}
    node = LandmarksNode(cfg, ch["scan"], ch["landmarks"],
                         ch["map"] if turtle_map else None, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(4):
        a = 2 * np.pi * i / 4
        pose = torch.tensor([a + np.pi / 2, 1.2 * np.cos(a),
                             1.2 * np.sin(a)], dtype=torch.float32)
        scan = tlidar.scan_cylinders(pose, world, radii, noise_std=1e-3,
                                     noise=torch.from_numpy(
                                         rng.standard_normal(360)).float())
        ch["scan"].publish(scan.numpy())
        node.tick(0.2 * i)
        circles = tl.feature_detection(cfg, scan)
        meas = ch["landmarks"].latest()
        want = tl.circles_to_measurements(circles).numpy()
        assert meas.dtype == want.dtype and meas.flags.c_contiguous
        np.testing.assert_array_equal(meas, want)
        assert np.isfinite(meas).all(-1).sum() >= 1
        if turtle_map:
            for got, exp in zip(ch["map"].latest(), circles):
                assert got.dtype == exp.numpy().dtype
                np.testing.assert_array_equal(got, exp.numpy())
