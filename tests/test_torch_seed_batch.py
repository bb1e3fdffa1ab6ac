"""The seed sweeps as one program (``tpunav``'s ``jax.vmap`` of a course
over seeds) on the CPU: K1 with its problem axis, the eigensolver, sensor
and detector over a batch of scans, the EKF over a batch of states, config
4's course over a seed batch (``control.slam_loop.run_slam_course`` on
``slam_batch_init``'s state) and the lidar EKF's
(``examples_torch.lidar_ekf_slam_demo.make_sim_batch``).

Each seed of a batch is held to its own serial run bit for bit, and the
batched lidar course to ``tpunav``'s vmapped course at the float32 bars of
ROADMAP.md §3 (pose 1e-5, landmarks 1e-4, the same landmarks and count),
with ``tpunav``'s scan normals (its key splits replayed) handed to the
port. ``capture.Graph`` runs each graph's body without capture here: the
bodies the card replays.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import lidar_ekf_slam_demo as jle
from examples_torch import dense_world_slam_demo as tdw
from examples_torch import lidar_ekf_slam_demo as tle
from examples_torch import seed_batch_sweeps
from tpunav.estimation.ekf import EKFConfig as JEKFConfig
from tpunav.estimation.ekf import known_correspondence_slam as j_known
from tpunav.estimation.ekf import slam_unknown_da as j_unknown
from tpunav_torch import batch
from tpunav_torch.control import slam_loop as sl
from tpunav_torch.control.mppi import MPPIConfig, init_controls
from tpunav_torch.estimation import landmarks as lm
from tpunav_torch.estimation.ekf import filter as ekff
from tpunav_torch.models.cart import CartParams
from tpunav_torch.ops import fused_mppi as fm
from tpunav_torch.ops import sym_eig
from tpunav_torch.sim import associate_known, scan_cylinders

torch.set_num_threads(2)

SEEDS = [0, 4, 7]
STEPS = 40
MODEL = CartParams(0.033, 0.160)


def _same(got, want):
    """Every tensor of two nests (tuples of tensors) bit for bit."""
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)


def _stack(states):
    return type(states[0])(*(torch.stack(t) for t in zip(*states)))


# ── (a) K1's problem axis ──


def _problems(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa
    u = init_controls(cfg, device="cpu") + f32(rng.uniform(
        -1.0, 1.0, (b, cfg.steps, 2)))
    return (u.contiguous(), f32(rng.uniform(-0.5, 0.5, (b, 3))),
            f32(rng.uniform(-1.5, 1.5, (b, 3))))


@pytest.mark.parametrize("seeds", ["one", "per_problem"])
def test_k1_batch_equals_single_solves(seeds):
    """K1 over 3 problems (distinct controls, poses and goals) in one call:
    each problem's (N, 2) update is its single solve's, bit for bit, with
    one in-kernel Philox seed for all problems (config 4's case) or one
    per problem."""
    cfg = MPPIConfig(horizon=0.4, dt=0.05, rollouts=100, ul_var=4.0,
                     ur_var=4.0)
    u, pose, xd = _problems(cfg, 3)
    seed = (torch.tensor(17, dtype=torch.int32) if seeds == "one" else
            torch.tensor([5, 900, 77], dtype=torch.int32))
    got = fm.mppi_solve_fused_batch(cfg, MODEL, u, seed, pose, xd)
    assert got.shape == (3, cfg.steps, 2)
    for i in range(3):
        s = seed if seeds == "one" else seed[i]
        want = fm._combine_reference(cfg, u[i], fm._solve_partials_reference(
            cfg, MODEL, u[i], s, pose[i], xd[i]), False)
        assert torch.equal(got[i], want)
        cmd, u_next = fm.mppi_solve_fused(cfg, MODEL, u[i], s, pose[i], xd[i])
        assert torch.equal(got[i, 0], cmd)
        assert torch.equal(got[i, 1:], u_next[:-1])
    assert not torch.equal(got[0], got[1])


def test_k1_batch_injected_noise_and_checks():
    """Injected (P, N, K, 2) noise takes each problem's slice; the shapes,
    the seed count and the obstacle mode are checked."""
    cfg = MPPIConfig(horizon=0.1, dt=0.05, rollouts=33)
    u, pose, xd = _problems(cfg, 2, seed=3)
    noise = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, cfg.steps, 33, 2)).astype(np.float32))
    got = fm.mppi_solve_fused_batch(cfg, MODEL, u, 0, pose, xd, noise)
    for i in range(2):
        want = fm._combine_reference(cfg, u[i], fm._solve_partials_reference(
            cfg, MODEL, u[i], 0, pose[i], xd[i], noise[i]), False)
        assert torch.equal(got[i], want)
    with pytest.raises(ValueError, match="one per problem"):
        fm.mppi_solve_fused_batch(cfg, MODEL, u, torch.zeros(3, dtype=
                                                            torch.int32),
                                  pose, xd)
    with pytest.raises(ValueError, match="shape"):
        fm.mppi_solve_fused_batch(cfg, MODEL, u, 0, pose[:1], xd)
    with pytest.raises(ValueError, match="one problem per launch"):
        fm._solve_update(cfg, MODEL, u, 0, pose, xd,
                         table=torch.zeros((2, 5)), lead=(2,))


# ── (e) The eigensolver, the sensor and the detector over a batch ──


def _scans(n, seed=0):
    """``n`` noisy scans of the lidar EKF's block world from poses on a
    small circle: (n, 360) ranges and the (n, 3) poses [θ, x, y]."""
    world = torch.tensor(tle.LANDMARKS, dtype=torch.float32)
    radii = torch.full((len(tle.LANDMARKS),), tle.CYL_RADIUS)
    a = torch.linspace(0.0, 2 * math.pi, n + 1)[:n]
    poses = torch.stack([a, 0.2 * torch.cos(a), 0.2 * torch.sin(a)], -1)
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 360)).astype(np.float32))
    scans = torch.stack([scan_cylinders(p, world, radii, noise_std=1e-3,
                                        noise=zz) for p, zz in zip(poses, z)])
    return scans, poses, world, radii, z


def test_sensor_and_detector_over_a_batch_equal_per_scan_calls():
    """The scan, the detector (``feature_detection``, with and without the
    inscribed-angle classification, whose roll to a cluster boundary
    shifts each scan by its own amount), the measurement hand-off and the
    known-DA oracle mapped over 4 scans equal the per-scan calls bit for
    bit."""
    scans, poses, world, radii, z = _scans(4)
    got = batch.vmap(lambda p, zz: scan_cylinders(
        p, world, radii, noise_std=1e-3, noise=zz))(poses, z)
    assert torch.equal(got, scans)
    for classify in (False, True):
        cfg = lm.LandmarkConfig(max_clusters=16, use_classify=classify)

        def chain(ranges, pose):
            meas = lm.circles_to_measurements(lm.feature_detection(cfg,
                                                                   ranges))
            return meas, associate_known(meas, world, pose)

        out = batch.vmap(chain)(scans, poses)
        for i in range(4):
            want = chain(scans[i], poses[i])
            for a, b in zip(out, want):
                assert torch.equal(torch.nan_to_num(a[i], 7.0),
                                   torch.nan_to_num(b, 7.0))
        assert int(torch.isfinite(out[0][:, :, 0]).sum()) >= 8


def test_roll_to_cluster_boundary_over_a_batch():
    """Each scan of a batch rolls by its own first gap: the mapped roll
    equals the per-scan roll, and two scans roll by different amounts."""
    scans, *_ = _scans(3, seed=1)
    cfg = lm.LandmarkConfig(max_clusters=16)
    pts, valid = lm.laser_end_points(cfg.props, scans[0])
    pts_b, valid_b = batch.vmap(lambda r: lm.laser_end_points(cfg.props,
                                                              r))(scans)
    rolled = batch.vmap(lambda p, v: lm._roll_to_cluster_boundary(
        cfg, p, v))(pts_b, valid_b)
    shifts = set()
    for i in range(3):
        want = lm._roll_to_cluster_boundary(
            cfg, *lm.laser_end_points(cfg.props, scans[i]))
        _same((rolled[0][i], rolled[1][i]), want)
        shifts.add(int(torch.argmax(lm._gap_flags(
            cfg, pts_b[i], valid_b[i]).to(torch.uint8))))
    assert len(shifts) > 1
    assert pts.shape == (360, 2)


@pytest.mark.parametrize("n", [4, 17])
def test_eigh_over_a_batch_equals_per_batch_calls(n):
    """``sym_eig.eigh`` folds leading dimensions into its batch, and under
    ``batch.vmap`` folds the mapped batch in too (one call): both equal the
    per-(C, S, S) calls bit for bit; a per-matrix ``skip`` under the map
    becomes one flag, set only where every matrix may skip."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn((3, 5, n, n), generator=g, dtype=torch.float64)
    a = x @ x.transpose(-1, -2)
    w, v = sym_eig.eigh(a)
    wm, vm = batch.vmap(sym_eig.eigh)(a)
    for i in range(3):
        wi, vi = sym_eig.eigh(a[i])
        _same((w[i], v[i], wm[i], vm[i]), (wi, vi, wi, vi))
    skip = torch.tensor([True, False, True])
    ws, _ = batch.vmap(sym_eig.eigh)(a, skip)
    assert torch.equal(ws, w)           # one matrix may not skip: all sweep
    wk, _ = batch.vmap(sym_eig.eigh)(a, torch.ones(3, dtype=torch.bool))
    want = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1).values
    assert torch.equal(wk, want)        # all may skip: none sweeps


def test_no_per_sample_fallback():
    """``batch.vmap`` refuses an operation without a batching rule, which
    ``torch.func.vmap`` would otherwise loop over the batch, and a random
    draw inside the body."""
    bad = batch.vmap(lambda a, i: torch.zeros(4).index_copy_(0, i, a))
    with pytest.raises(RuntimeError, match="fallback"):
        bad(torch.ones(2, 1), torch.zeros(2, 1, dtype=torch.long))
    with pytest.raises(RuntimeError):
        batch.vmap(lambda a: a + torch.randn(()))(torch.ones(2))
    assert torch._C._functorch._is_vmap_fallback_enabled()


# ── The EKF over a batch of states ──


@pytest.mark.parametrize("known", [True, False])
def test_ekf_stepper_over_a_batch_equals_serial_updates(known):
    """``EKFStepper`` over 3 states: 12 updates of the masked form mapped
    over the batch give each state its serial stepper's bits."""
    _, _, cfg = tle.CONFIGS["known" if known else "unknown"]
    rows = 12 if known else 16
    scans, poses, world, radii, _ = _scans(12, seed=5)
    det = lm.LandmarkConfig(max_clusters=16)
    meas = torch.stack([lm.circles_to_measurements(lm.feature_detection(
        det, r)) for r in scans])
    if known:
        meas = torch.stack([associate_known(m, world, p)
                            for m, p in zip(meas, poses)])
    st = ekff.ekf_init(cfg, dtype=torch.float32, device="cpu")
    many = ekff.EKFStepper(cfg, _stack([st] * 3), rows, known, "cpu")
    ones = [ekff.EKFStepper(cfg, st, rows, known, "cpu") for _ in range(3)]
    u = torch.tensor([0.03, 0.015])
    for t in range(12):
        m = torch.stack([meas[(t + i) % 12] for i in range(3)])
        got = many.step(m, torch.stack([u * (1 + 0.1 * i)
                                        for i in range(3)]))
        for i in range(3):
            want = ones[i].step(m[i], u * (1 + 0.1 * i))
            _same(tuple(x[i] for x in got), want)
    assert int(got.count.min()) >= 4


# ── (b), (c) The lidar EKF course over a seed batch ──


def _tpunav_courses(tag):
    """``tpunav``'s lidar EKF course over SEEDS (x64 off): its ``jax.vmap``
    as ``run_many`` takes it and each seed's course alone, and each seed's
    scan normals (make_sim's key splits,
    examples/lidar_ekf_slam_demo.py:57-64)."""
    _, known, cfg = tle.CONFIGS[tag]
    jcfg = JEKFConfig(**dataclasses.asdict(cfg))
    with jax.enable_x64(False):
        sim = jle.make_sim(j_known if known else j_unknown, jcfg, known,
                           STEPS)
        keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
        vmapped = jax.jit(jax.vmap(sim))(keys)
        alone = [jax.jit(sim)(jax.random.PRNGKey(s)) for s in SEEDS]
        normals = []
        for s in SEEDS:
            key, rows = jax.random.PRNGKey(s), []
            for _ in range(STEPS):
                key, k1 = jax.random.split(key)
                rows.append(np.asarray(jax.random.normal(k1, (360,),
                                                         jnp.float32)))
            normals.append(np.stack(rows))
    seeds = [(np.asarray(vmapped[0][i]), jax.tree_util.tree_map(
        lambda x, i=i: np.asarray(x[i]), vmapped[2]), np.asarray(one[0]),
        jax.tree_util.tree_map(np.asarray, one[2]))
        for i, one in enumerate(alone)]
    return seeds, torch.from_numpy(np.stack(normals))


def _assert_near(pose, st, want_pose, want, slack=0.0):
    """The float32 bars of ROADMAP.md §3 (``test_torch_examples_ekf``):
    pose within 1e-5, landmarks within 1e-4 (each plus ``slack``), the
    same landmarks and count."""
    np.testing.assert_allclose(pose.numpy(), want_pose, rtol=0,
                               atol=1e-5 + slack)
    np.testing.assert_allclose(st.state[:3].numpy(), want.state[:3], rtol=0,
                               atol=1e-5 + slack)
    active = want.active
    np.testing.assert_array_equal(st.active.numpy(), active)
    np.testing.assert_allclose(
        st.state[3:].reshape(-1, 2).numpy()[active],
        want.state[3:].reshape(-1, 2)[active], rtol=0, atol=1e-4 + slack)
    assert int(st.count) == int(want.count) >= 10


@pytest.mark.parametrize("tag", ["known", "unknown"])
def test_lidar_batch_matches_tpunav_vmap(tag):
    """The batched course with ``tpunav``'s normals injected, seed by seed,
    against ``tpunav``'s vmapped course and each seed's ``tpunav`` course
    alone: at the float32 bars of ``test_torch_examples_ekf`` (set on seed
    0) plus the gap between ``tpunav``'s two courses of that seed. XLA
    rounds the vmapped filter otherwise than one, by up to 2.24e-5 m in
    the filter's state at 40 steps, and the float32 filters drift apart
    by as much from seed to seed (ROADMAP.md §3); the port's batch gives
    each seed its serial bits (``test_lidar_batch_equals_serial_courses``).
    The landmarks and their count are the same."""
    step, known, cfg = tle.CONFIGS[tag]
    seeds, normals = _tpunav_courses(tag)
    pose, _, st, tel = tle.make_sim_batch(step, cfg, known, len(SEEDS),
                                          STEPS, "cpu")(SEEDS, noise=normals)
    assert tel.shape == (len(SEEDS), STEPS, 5) and torch.isfinite(tel).all()
    for i, (v_pose, v_st, a_pose, a_st) in enumerate(seeds):
        got = ekff.EKFState(*(t[i] for t in st))
        gap = max(float(np.abs(v_pose - a_pose).max()),
                  float(np.abs(v_st.state - a_st.state).max()))
        for want_pose, want in ((v_pose, v_st), (a_pose, a_st)):
            _assert_near(pose[i], got, want_pose, want, slack=gap)


@pytest.mark.parametrize("tag", ["known", "unknown"])
def test_lidar_batch_equals_serial_courses(tag):
    """The batched course from each seed's generator against ``make_sim``'s
    serial course of that seed, bit for bit (poses, filter, telemetry),
    and ``run_many``'s batched sweep equal to the serial sweep
    (``seed_batch_sweeps.serial``)."""
    step, known, cfg = tle.CONFIGS[tag]
    got = tle.make_sim_batch(step, cfg, known, len(SEEDS), STEPS,
                             "cpu")(SEEDS)
    serial = tle.make_sim(step, cfg, known, STEPS, "cpu")
    for i, seed in enumerate(SEEDS):
        _same(tuple(x[i] for x in (got[0], got[1], *got[2], got[3])),
              (lambda r: (r[0], r[1], *r[2], r[3]))(serial(seed)))
    many = tle.run_many(step, cfg, known, SEEDS, STEPS, "cpu")
    one_by_one = seed_batch_sweeps.serial(1 if known else 2, SEEDS, STEPS,
                                          "cpu")[0]
    for a, key in zip(many[:3], ("ekf_err", "odo_err", "count")):
        np.testing.assert_array_equal(a, one_by_one[key])


# ── (d) Config 4 over a seed batch ──


def test_config4_batch_equals_serial_courses(monkeypatch):
    """84 ticks of config 4 at K=64 over 3 seeds (a 60-tick chunk and a
    24-tick one) through ``run_slam_course`` on a seed batch, one K1 call
    per tick for all seeds: each seed's state, telemetry rows and generator
    equal its serial ``course`` (``run_slam_course``'s chunks) bit for
    bit."""
    course = tdw.build(steps=84, rollouts=64, device="cpu")[0]
    course_batch = tdw.build_batch(steps=84, rollouts=64, device="cpu")
    calls = []
    solve = fm.mppi_solve_fused_batch

    def counted(*args, **kwargs):
        calls.append(args[2].shape[0])
        return solve(*args, **kwargs)

    monkeypatch.setattr(fm, "mppi_solve_fused_batch", counted)
    out = course_batch(SEEDS)
    assert calls == [len(SEEDS)] * 84
    st = out["state"]
    assert st.host_ticks == 84 and out["tel_t"].shape == (3, 84, 5)
    for i, seed in enumerate(SEEDS):
        one = course(seed)
        got, want = sl.seed_state(st, i), one["state"]
        for f in sl._FIELDS:
            _same(getattr(got, f), getattr(want, f))
        assert torch.equal(got.generator.get_state(),
                           want.generator.get_state())
        assert torch.equal(out["tel_t"][i], one["tel_t"])
        np.testing.assert_array_equal(out["ekf_err"][i], one["ekf_err"])
        assert out["count"][i] == one["count"] >= 10
    assert not torch.equal(out["tel_t"][0], out["tel_t"][1])


def test_batch_course_checks():
    """The course takes a serial state or a seed batch, the batch on the
    fused backend from a sensing tick, and a batch's states share one tick
    count."""
    mppi, ekf, loop = tdw.configs(32)
    world = torch.from_numpy(tdw.dense_world())
    ring = torch.from_numpy(tdw.waypoint_ring())
    one = sl.slam_loop_init(mppi, ekf, device="cpu")
    many = sl.slam_batch_init(mppi, ekf, [0, 1], device="cpu")
    assert many.true_pose.shape == (2, 3) and len(many.generator) == 2
    assert torch.equal(many.generator[1].get_state(),
                       sl.slam_loop_init(mppi, ekf, seed=1,
                                         device="cpu").generator.get_state())
    run = lambda st, cfg=loop: sl.run_slam_course(  # noqa: E731
        mppi, ekf, cfg, MODEL, ring, world, st, 1)
    assert run(one)[0].true_pose.shape == (3,)
    assert run(many)[0].true_pose.shape == (2, 3)
    with pytest.raises(ValueError, match="fused backend"):
        run(many, dataclasses.replace(loop, use_fused=False))
    with pytest.raises(ValueError, match="sensing tick"):
        run(many._replace(host_ticks=1))
    with pytest.raises(ValueError, match="one tick count"):
        sl.stack_states([one, one._replace(host_ticks=4)])
