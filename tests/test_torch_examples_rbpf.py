"""The closed-loop RBPF demos of the port (``examples_torch.
rbpf_explore_demo``, ``examples_torch.full_stack_demo``) against
``tpunav``'s (``examples/``).

- Exploration: ``body_twist``; one control tick (K1's plain version with
  injected noise → the motors → RK4 on truth and biased odometry → the
  waypoint advance) against the same tick composed from ``tpunav``'s
  public functions (its ``build`` draws the noise in the kernel and cannot
  be fed); a checkpoint and resume bit-equal to the run it was saved
  from; the seed sweep.
- The stage profile (``examples_torch.profile_rbpf_stages``): its three
  stage graphs chained per scan leave the state, generators and samples
  that the demo's one ``ScanGraph`` replay per scan leaves, and both of its
  profiles run on the CPU path.
- Full stack: ``make_world`` and ``occupancy_to_labels``; two scan
  intervals (the motion-model update, then the ICP one), each from
  ``tpunav``'s state, on both controller backends: ``tpunav``'s control
  chunk, scan and ``pf_slam_step`` composed from its public functions with
  the noise each draws handed to the port (``noise=`` seams), then both
  packages' labels and D* Lite paths; and both planners fed one label
  sequence.

On the CPU every kernel of the port takes its plain version. Trajectories
of whole courses are not compared: K1's in-kernel Philox and the
λ = 0.01 softmax make them part (ROADMAP.md §3); courses are judged by
outcome on the card (chip_smoke.py's ``explore`` and ``full_stack``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from examples import full_stack_demo as jfs
from examples import rbpf_explore_demo as jex
from examples_torch import full_stack_demo as tfs
from examples_torch import profile_rbpf_stages as prof
from examples_torch import rbpf_explore_demo as tex
from examples_torch import rbpf_slam_demo as trs
from tpunav.control import mppi as jm
from tpunav.estimation.rbpf import GridConfig as JGridConfig
from tpunav.estimation.rbpf import best_particle as j_best
from tpunav.estimation.rbpf.icp import ICPConfig as JICPConfig
from tpunav.estimation.rbpf import particle_filter as jpf
from tpunav.models.cart import kinematic_cart as j_cart
from tpunav.ops.pallas_mppi import mppi_solve_fused as j_fused
from tpunav.ops.rk4 import rk4_step as j_rk4
from tpunav.planning.dstar import dstar_from_labels as j_dstar
from tpunav.sim import lidar as jlidar
from tpunav.sim.motor import track as j_track
from tpunav_torch import capture, interop
from tpunav_torch.control.mppi import MPPIConfig
from tpunav_torch.control.mppi import cost_to_go as t_cost_to_go
from tpunav_torch.control.mppi import mppi_solve as t_solve
from tpunav_torch.control.mppi import rollout_losses as t_rollout_losses
from tpunav_torch.estimation.rbpf import PFConfig
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.ops.fused_mppi import mppi_solve_fused as t_fused
from tpunav_torch.planning.dstar import dstar_from_labels as t_dstar
from tpunav_torch.planning.grid_map import FREE, OBSTACLE

torch.set_num_threads(2)

F32 = jnp.float32
POSE_BAR = 1e-5
U_BAR = 1e-4             # a row of a solve's update (test_torch_waypoint_loop)
NEAR_TIE_ULPS = 16       # the near-tie rule of tests/test_torch_waypoint_loop
K = 128                  # tpunav's fused solve takes K in blocks of 128


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _scaled_noise(cfg, rng):
    """(N, K, 2) perturbations, scaled as both packages' solves take them."""
    z = rng.standard_normal((cfg.steps, cfg.rollouts, 2)).astype(np.float32)
    return z * np.sqrt([cfg.ul_var, cfg.ur_var]).astype(np.float32)


def _jax_noise(jcfg, key):
    """The normals tpunav's pf_slam_step draws from ``key``
    (particle_filter.py:250-251, :176-182, :205, :106, :218), as in
    tests/test_torch_rbpf.py."""
    p, k = jcfg.num_particles, jcfg.k_samples
    _, _, k_particles, k_res = jax.random.split(key, 4)
    pkeys = jax.random.split(k_particles, p)
    samples, pose, motion = [], [], []
    for pk in pkeys:
        k1, k2 = jax.random.split(pk)
        samples.append(jax.random.normal(k1, (k, 3), F32))
        pose.append(jax.random.normal(k2, (3,), F32))
        motion.append(jax.random.normal(pk, (3,), F32))
    return tpf.PFNoise(samples=_t(np.stack(samples)), pose=_t(np.stack(pose)),
                       motion=_t(np.stack(motion)),
                       resample=_t(jax.random.normal(k_res, (), F32)))


_STATE = ("poses", "prev_poses", "log_weights", "grids", "dists",
          "prev_scan", "has_prev")


def _port_pf(jst):
    return interop.pf_state_from_numpy(
        {name: np.asarray(getattr(jst, name)) for name in _STATE},
        device="cpu")


# ------------------------------------------------------------ exploration --

@pytest.mark.parametrize("cur,prev", [
    ([0.3, 0.12, -0.05], [0.25, 0.1, -0.06]),
    ([-3.1, 0.5, 0.5], [3.1, 0.49, 0.52]),        # heading wraps at ±π
    ([1.2, -0.9, 0.9], [1.2, -0.9, 0.9]),         # no motion
    ([0.0, 0.0, 0.0], [-0.4, 0.02, -0.01]),
])
def test_body_twist_matches_tpunav(cur, prev):
    got = tex.body_twist(_t(cur), _t(prev)).numpy()
    want = np.asarray(jex.body_twist(jnp.asarray(cur, F32),
                                     jnp.asarray(prev, F32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("odom,wpt_idx", [
    ([0.1, 0.85, 0.05], 0),       # 0.15 m short of waypoint 0: advances
    ([1.2, 0.3, -0.4], 2),        # far from waypoint 2: holds
])
def test_control_tick_matches_tpunav(odom, wpt_idx):
    """One 60 Hz tick of the exploration loop, K1's plain version with
    tpunav's injected noise, against tpunav's functions composed as its
    control_tick (examples/rbpf_explore_demo.py:91-121)."""
    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=K)
    jcfg = jm.MPPIConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(3)
    noise = _scaled_noise(cfg, rng)
    true = np.array(odom, np.float32) + np.float32(0.01)
    u = rng.normal(scale=0.5, size=(cfg.steps, 2)).astype(np.float32)
    wheel = np.array([1.0, 1.3], np.float32)
    bias = np.asarray(tex.WHEEL_BIAS, np.float32)

    # tpunav: examples/rbpf_explore_demo.py:93-121, one tick.
    wpts = jex.WAYPOINTS
    jo = jnp.asarray(odom, F32)
    wpt = wpts[wpt_idx]
    d2g = jnp.hypot(jo[1] - wpt[0], jo[2] - wpt[1])
    jidx = jnp.where(d2g < 0.15, (wpt_idx + 1) % wpts.shape[0], wpt_idx)
    wpt = wpts[jidx]
    cmd, ju = j_fused(jcfg, jex.MODEL, jnp.asarray(u), 7,
                      jnp.stack([jo[1], jo[2], jo[0]]), wpt,
                      noise=jnp.asarray(noise.reshape(cfg.steps, K // 128,
                                                      128, 2)),
                      interpret=True)
    jw = j_track(jex.MOTOR, jnp.asarray(wheel), cmd, jex.TICK_DT)
    f = lambda x, uu: j_cart(jex.MODEL, x, uu)  # noqa: E731
    jt = jnp.asarray(true)
    jt = j_rk4(f, jnp.stack([jt[1], jt[2], jt[0]]), jw, jex.TICK_DT)
    jo = j_rk4(f, jnp.stack([jo[1], jo[2], jo[0]]), jw * bias, jex.TICK_DT)

    t_true, t_odom, t_u, t_wheel, t_idx = tex.control_tick(
        cfg, _t(tex.WAYPOINTS), _t(bias), _t(true), _t(odom), _t(u),
        _t(wheel), torch.tensor(wpt_idx, dtype=torch.int32), 7,
        noise=_t(noise))
    assert int(t_idx) == int(jidx)
    np.testing.assert_allclose(t_u.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t_wheel.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-5)
    for got, want in [(t_true, jt), (t_odom, jo)]:
        want = np.asarray(want)[[2, 0, 1]]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POSE_BAR)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """Two chunks of three scans equal one chunk, a checkpoint to disk and
    back (the filter's and the lidar's generators included), and one
    chunk, bit for bit."""
    pf_cfg, mppi_cfg, run_chunk = tex.build(16, scans_per_chunk=3,
                                            rollouts=64, device="cpu")
    straight = run_chunk(run_chunk(tex.init_state(pf_cfg, mppi_cfg,
                                                  device="cpu")))
    half = run_chunk(tex.init_state(pf_cfg, mppi_cfg, device="cpu"))
    restored = tex.checkpoint_roundtrip(half, str(tmp_path / "ckpt.npz"))
    assert restored.tick == 3 and isinstance(restored.tick, int)
    assert restored.scan_gen is not half.scan_gen
    resumed = run_chunk(restored)
    assert tex.digests(resumed) == tex.digests(straight)
    for name in ("true_pose", "odom_pose", "wheel_vel", "wpt_idx"):
        assert torch.equal(getattr(resumed, name), getattr(straight, name))
    assert resumed.tick == straight.tick == 6


def test_seed_sweep_returns_finite_errors():
    slam, odom = tex.seed_sweep(seeds=(0, 1), num_particles=16, chunks=1,
                                scans_per_chunk=2, rollouts=64, device="cpu")
    assert slam.shape == odom.shape == (2, 3)
    assert np.isfinite(slam).all() and np.isfinite(odom).all()
    np.testing.assert_array_equal(odom[0], odom[1])   # the filter's seed only


def _explore_runs(eager, chunks=2):
    """``chunks`` chunks of three scans at P=8, K=64 from the start, with
    the series."""
    pf_cfg, mppi_cfg, run_chunk = tex.build(8, 3, 64, "cpu", eager=eager)
    st, series = tex.init_state(pf_cfg, mppi_cfg, device="cpu"), []
    for _ in range(chunks):
        st = run_chunk(st, series)
    return st, torch.stack(series)


def _assert_explore_equal(got, want):
    assert tex.digests(got) == tex.digests(want)
    for name in ("true_pose", "odom_pose", "u", "wheel_vel", "wpt_idx"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.tick == want.tick
    for a, b in [(got.scan_gen, want.scan_gen),
                 (got.pf.generator, want.pf.generator)]:
        assert torch.equal(a.get_state(), b.get_state())


def test_explore_graph_equals_eager():
    """Two chunks of three scans through ``ScanGraph`` (``build``'s
    default) and through the eager interval: every leaf, both generators
    and the six five-metric samples bit for bit."""
    (eager, s_eager), (graph, s_graph) = (_explore_runs(e) for e in
                                          (True, False))
    _assert_explore_equal(graph, eager)
    assert graph.tick == 6 and s_graph.shape == (6, 5)
    assert torch.equal(s_graph, s_eager)


def test_explore_graph_loads_a_resumed_state_in_place(tmp_path):
    """A ``ScanGraph`` checkpointed after three scans, then given another
    state and the restored checkpoint through ``load``: its buffers and
    generators stay the ones its graph reads (never rebound), and three
    more scans give the uninterrupted six's state bit for bit. A runner
    whose state is rebound instead of loaded replays its old buffers, and
    the same check catches it."""
    pf_cfg, mppi_cfg = tex.configs(8, 64)
    start = tex.init_state(pf_cfg, mppi_cfg, device="cpu")
    g = tex.ScanGraph(pf_cfg, mppi_cfg, start, "cpu")
    for _ in range(3):
        g.step()
    restored = tex.checkpoint_roundtrip(g.snapshot(),
                                        str(tmp_path / "ckpt.npz"))
    for _ in range(3):
        g.step()
    straight = g.snapshot()

    buffers = [t.data_ptr() for t in (*g.stepper.state[:-1], *g.carry,
                                      g.tick_dev)]
    gens = (g.stepper.state.generator, g.scan_gen)
    g.load(tex.init_state(pf_cfg, mppi_cfg, seed=99, device="cpu"))
    g.load(restored)
    assert [t.data_ptr() for t in (*g.stepper.state[:-1], *g.carry,
                                   g.tick_dev)] == buffers
    assert (g.stepper.state.generator, g.scan_gen) == gens
    assert g.tick == 3 and int(g.tick_dev) == 3
    for _ in range(3):
        g.step()
    _assert_explore_equal(g.snapshot(), straight)

    rebound = tex.ScanGraph(pf_cfg, mppi_cfg, start, "cpu")
    rebound.stepper.state = restored.pf
    rebound.carry = (restored.true_pose, restored.odom_pose, restored.u,
                     restored.wheel_vel, restored.wpt_idx)
    rebound.tick = restored.tick
    for _ in range(3):
        rebound.step()
    assert tex.digests(rebound.snapshot()) != tex.digests(straight)


def test_chained_stage_graphs_leave_the_scan_graphs_state():
    """Four scans through ``ChainedStages``' three graphs (control chunk,
    raycast, ``PFStepper``'s update) against four ``ScanGraph`` replays
    from the same state: every sample, leaf and generator bit for bit; the
    two forms then alternate on the chained runner's buffers."""
    pf_cfg, mppi_cfg = tex.configs(8, 64)
    start = tex.init_state(pf_cfg, mppi_cfg, device="cpu")
    chained = prof.ChainedStages(pf_cfg, mppi_cfg, start, "cpu")
    one = tex.ScanGraph(pf_cfg, mppi_cfg, start, "cpu")
    for i in range(4):
        got = (chained.step() if i % 2 == 0
               else chained.scan_graph.step()).clone()
        assert torch.equal(got, one.step()), i
    _assert_explore_equal(chained.scan_graph.snapshot(), one.snapshot())
    assert one.tick == 4


def test_stage_profiles_run_on_the_cpu():
    """``profile_closed_loop`` and ``stage_times`` on the CPU path of their
    graphs, shrunk: every stage timed, the chained stages' sum beside the
    one replay."""
    loop = prof.profile_closed_loop(num_particles=8, reps=2, rollouts=64,
                                    device="cpu")
    assert set(prof.STAGES) < set(loop)
    assert loop["stages chained (sum)"] == pytest.approx(
        sum(loop[name] for name in prof.STAGES))
    assert loop["ScanGraph scan (one replay)"] > 0
    stages = prof.stage_times(num_particles=8, reps=1, device="cpu")
    assert len(stages) == 7 and all(v > 0 for v in stages.values())


def _jax_explore_interval(jcfg, true, odom, u, wheel, idx, rng):
    """tpunav's control chunk (examples/rbpf_explore_demo.py:84-122) from
    its public functions with injected noise; returns its state and each
    tick's (N, K, 2) noise."""
    f = lambda x, uu: j_cart(jex.MODEL, x, uu)  # noqa: E731
    bias = jnp.asarray(tex.WHEEL_BIAS, F32)
    wpts = jex.WAYPOINTS
    noises = []
    for _ in range(tex.TICKS_PER_SCAN):
        wpt = wpts[idx]
        d2g = jnp.hypot(odom[1] - wpt[0], odom[2] - wpt[1])
        idx = jnp.where(d2g < 0.15, (idx + 1) % wpts.shape[0], idx)
        z = _scaled_noise(jcfg, rng)
        cmd, u = j_fused(jcfg, jex.MODEL, u, 0,
                         jnp.stack([odom[1], odom[2], odom[0]]), wpts[idx],
                         noise=jnp.asarray(z.reshape(jcfg.steps, K // 128,
                                                     128, 2)),
                         interpret=True)
        noises.append(z)
        wheel = j_track(jex.MOTOR, wheel, cmd, jex.TICK_DT)
        xyt = [j_rk4(f, jnp.stack([p[1], p[2], p[0]]), w, jex.TICK_DT)
               for p, w in ((true, wheel), (odom, wheel * bias))]
        true, odom = (jnp.stack([p[2], p[0], p[1]]) for p in xyt)
    return true, odom, u, wheel, idx, np.stack(noises)


def test_explore_graph_intervals_match_tpunav():
    """Two scan intervals of the exploration loop at P=16, K=128 (the
    motion-model update, then the ICP one), each from tpunav's state,
    through one injected ``ScanGraph``: tpunav's six solves' noise, its
    scan's normals and its filter's into the static tensors. Poses,
    particles and the first four metrics within POSE_BAR, N_eff within
    1e-4 relative, the scan within 1e-5, the waypoint index equal."""
    pf_cfg, mppi_cfg = tex.configs(16, K)
    jpf_cfg = jpf.PFConfig(num_particles=16, k_samples=50,
                           sample_range=(1e-6, 1e-5, 1e-5),
                           motion_noise=(1e-6, 1e-5, 1e-5),
                           grid=JGridConfig(), icp=JICPConfig(max_iter=25))
    assert interop.config_from_fields(
        PFConfig, dataclasses.asdict(jpf_cfg)) == pf_cfg
    jmppi = jm.MPPIConfig(**dataclasses.asdict(mppi_cfg))
    grid = pf_cfg.grid
    segs = jlidar.box_segments(-1.8, -1.8, 1.8, 1.8, F32)
    step = jax.jit(lambda s, sc, ub, c, pr: jpf.pf_slam_step(
        jpf_cfg, s, sc, ub, c, pr, backend="xla"))
    rng = np.random.default_rng(5)
    z3 = jnp.zeros(3, F32)
    true, odom, wheel, idx = z3, z3, jnp.zeros(2, F32), jnp.asarray(0)
    u = jm.init_controls(jmppi, dtype=F32)
    jst = jpf.pf_init(jpf_cfg, seed=3)
    runner = None
    for tick in range(2):
        start = tex.ExploreState(
            _port_pf(jst), _t(true), _t(odom), _t(u), _t(wheel),
            torch.tensor(int(idx), dtype=torch.int32), tick,
            torch.Generator())
        noise_pf = _jax_noise(jpf_cfg, jst.key)
        prev = odom
        true, odom, u, wheel, idx, k1 = _jax_explore_interval(
            jmppi, true, odom, u, wheel, idx, rng)
        key = jax.random.fold_in(jax.random.PRNGKey(tex.SCAN_SEED), tick)
        scan = jlidar.scan_segments(true, segs, num_beams=grid.num_beams,
                                    max_range=grid.range_max, key=key,
                                    noise_std=0.002)
        normals = _t(jax.random.normal(key, (grid.num_beams,), F32))
        jst = step(jst, scan, jex.body_twist(odom, prev), odom, prev)
        pose, _ = j_best(jst)
        w = jax.nn.softmax(jst.log_weights)
        want = np.asarray([
            jnp.hypot(pose[1] - true[1], pose[2] - true[2]),
            jex.normalize_angle_pi(pose[0] - true[0]),
            jnp.hypot(odom[1] - true[1], odom[2] - true[2]),
            jex.normalize_angle_pi(odom[0] - true[0]), 1.0 / jnp.sum(w * w)])

        if runner is None:
            runner = tex.ScanGraph(pf_cfg, mppi_cfg, start, "cpu",
                                   injected=True)
        runner.load(start)
        sample = runner.step(noise=(_t(k1), normals, noise_pf)).numpy()
        for name, got, want_ in [("true", runner.carry[0], true),
                                 ("odom", runner.carry[1], odom),
                                 ("particles", runner.stepper.state.poses,
                                  jst.poses)]:
            np.testing.assert_allclose(got.numpy(), np.asarray(want_),
                                       rtol=0, atol=POSE_BAR,
                                       err_msg=f"scan {tick}: {name}")
        np.testing.assert_allclose(runner.stepper.inputs[0].numpy(),
                                   np.asarray(scan), rtol=0, atol=1e-5)
        np.testing.assert_allclose(sample[:4], want[:4], rtol=0,
                                   atol=POSE_BAR)
        np.testing.assert_allclose(sample[4], want[4], rtol=1e-4)
        assert int(runner.carry[4]) == int(idx)
        assert runner.tick == tick + 1


def test_rbpf_course_graph_equals_eager_and_tpunav():
    """Four updates of rbpf_slam_demo's course at P=8 with tpunav's scans
    and normals (examples/rbpf_slam_demo.py:45-58): through ``PFStepper``
    (the default) and eagerly, bit for bit; against tpunav's updates,
    the particles within POSE_BAR. And the course with the filter's own
    draws, graph against eager, bit for bit."""
    cfg = trs.config(8)
    jcfg = jpf.PFConfig(num_particles=8, k_samples=50,
                        sample_range=(1e-6, 1e-5, 1e-5),
                        motion_noise=(1e-6, 1e-5, 1e-5),
                        grid=JGridConfig(resolution=0.05, xmin=-2.0,
                                         xmax=2.0, ymin=-2.0, ymax=2.0,
                                         num_beams=360),
                        icp=JICPConfig(max_iter=25))
    assert interop.config_from_fields(
        PFConfig, dataclasses.asdict(jcfg)) == cfg
    segs = jlidar.box_segments(-1.8, -1.8, 1.8, 1.8, F32)
    u = jnp.asarray(trs.U, F32)
    step = jax.jit(lambda s, sc, c, pr: jpf.pf_slam_step(
        jcfg, s, sc, u, c, pr, backend="xla"))
    jst = jpf.pf_init(jcfg, seed=2)
    pose = prev = jnp.zeros(3, F32)
    scans, odoms, prevs, noise = [], [], [], []
    for i in range(4):
        th = pose[0] + u[0]
        pose = jnp.stack([th, pose[1] + u[1] * jnp.cos(th),
                          pose[2] + u[1] * jnp.sin(th)])
        key = jax.random.fold_in(jax.random.PRNGKey(99), i)
        scan = jlidar.scan_segments(pose, segs, num_beams=360,
                                    max_range=cfg.grid.range_max, key=key,
                                    noise_std=0.002)
        noise.append(_jax_noise(jcfg, jst.key))
        jst = step(jst, scan, pose, prev)
        scans.append(_t(scan))
        odoms.append(_t(pose))
        prevs.append(_t(prev))
        prev = pose
    inputs = (_t(u), scans, odoms, prevs)
    graph = trs.course(cfg, inputs, 2, "cpu", noise=noise)
    eager = trs.course(cfg, inputs, 2, "cpu", eager=True, noise=noise)
    for name, a, b in zip(tpf.PFState._fields[:-1], graph[:-1], eager[:-1]):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(graph.poses.numpy(), np.asarray(jst.poses),
                               rtol=0, atol=POSE_BAR)
    drawn = [trs.course(cfg, inputs, 2, "cpu", eager=e) for e in (False,
                                                                 True)]
    for name, a, b in zip(tpf.PFState._fields[:-1], *(d[:-1] for d in
                                                      drawn)):
        assert torch.equal(a, b), name
    assert torch.equal(drawn[0].generator.get_state(),
                       drawn[1].generator.get_state())


# ------------------------------------------------------------- full stack --

def test_make_world_matches_tpunav():
    np.testing.assert_array_equal(tfs.make_world(device="cpu").numpy(),
                                  np.asarray(jfs.make_world()))


@pytest.mark.parametrize("inflate", [0, 3])
def test_occupancy_to_labels_matches_tpunav(inflate):
    grid = tfs.configs()[0].grid
    rng = np.random.default_rng(inflate)
    log_odds = rng.normal(scale=1.5, size=(grid.height, grid.width)).astype(
        np.float32)
    # Cells at l_occ exactly, and one ulp either side of it.
    l_occ = np.float32(grid.l_occ)
    log_odds[5, :3] = [l_occ, np.nextafter(l_occ, np.float32(-9)),
                       np.nextafter(l_occ, np.float32(9))]
    got = tfs.occupancy_to_labels(grid, log_odds, inflate)
    want = jfs.occupancy_to_labels(grid, log_odds, inflate)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got == OBSTACLE).any() and (got == FREE).any()


def _jax_chunk(jcfg, use_fused, true, odom, slam, u, target, tick, seed,
               rng, ticks):
    """tpunav's control chunk (examples/full_stack_demo.py:112-143) from
    its public functions; returns its poses, u, and the (N, K, 2) noise of
    each tick, as the port's ``control_chunk`` takes it."""
    f = lambda x, uu: j_cart(jfs.MODEL, x, uu)  # noqa: E731
    bias = jnp.asarray(tfs.WHEEL_BIAS, F32)

    def step_pose(p, c):
        xyt = j_rk4(f, jnp.stack([p[1], p[2], p[0]]), c, 1.0 / 60.0)
        return jnp.stack([xyt[2], xyt[0], xyt[1]])

    noises, solves = [], []
    for t in range(ticks):
        pose_xyt = jnp.stack([slam[1], slam[2], slam[0]])
        u_in = u
        if use_fused:
            z = _scaled_noise(jcfg, rng)
            cmd, u = j_fused(jcfg, jfs.MODEL, u, tick * ticks + t, pose_xyt,
                             target, noise=jnp.asarray(z.reshape(
                                 jcfg.steps, K // 128, 128, 2)),
                             interpret=True)
        else:
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed), tick), t)
            z = np.asarray(jm.sample_perturbations(jcfg, key, dtype=F32)
                           ).transpose(1, 0, 2)
            cmd, u = jm.mppi_solve(jcfg, jfs.MODEL, u, key, pose_xyt, target)
        noises.append(_t(z))
        solves.append((_t(u_in), _t(pose_xyt),
                       np.concatenate([np.asarray(cmd)[None],
                                       np.asarray(u)[:-1]])))
        true = step_pose(true, cmd)
        odom = step_pose(odom, cmd * bias)
        slam = step_pose(slam, cmd * bias)
    return true, odom, slam, u, noises, solves


def _rounding_slack(cfg, u, pose_xyt, target, noise_nkc, dj=None):
    """chip_smoke.py's ``rounding_slack``, from the port's float32
    cost-to-go J of the solve (the J its update weights): per update row t
    whether its two best rollouts lie within ε_t = max(16, N − t) float32
    ulps (rounding can swap them), and per row and column how far ε of
    every J moves the update to first order, (1/λ)·Σ_k w_k·ε_k·|z_k − ū|.
    ``dj``: the two packages' measured float32 J difference, (N, K), where
    ε takes the larger of it and ε_t ulps."""
    d = torch.float64
    loss, _ = t_rollout_losses(cfg, tfs.MODEL, pose_xyt,
                               u[None] + noise_nkc.transpose(0, 1), target)
    j32 = t_cost_to_go(loss).numpy()                           # (N, K)
    j, z = torch.from_numpy(j32.astype(np.float64)), noise_nkc.to(d)
    spacing = torch.from_numpy(np.spacing(np.abs(j32)).astype(np.float64))
    n = j.shape[0]
    ulps = torch.clamp(n - torch.arange(n, dtype=d),
                       min=NEAR_TIE_ULPS)[:, None]
    two, idx = torch.topk(j, 2, dim=1, largest=False)
    tie = (two[:, 1] - two[:, 0]) < ulps[:, 0] * torch.gather(
        spacing, 1, idx[:, :1])[:, 0]
    eps = ulps * spacing
    if dj is not None:
        eps = torch.maximum(eps, torch.from_numpy(dj))
    e = torch.exp((two[:, :1] - j) / cfg.lambda_)
    w = e / e.sum(dim=1, keepdim=True)
    ubar = torch.einsum("nk,nkc->nc", w, z)
    slack = torch.einsum("nk,nkc->nc", w * eps,
                         (z - ubar[:, None]).abs()) / cfg.lambda_
    return tie.numpy(), slack.numpy()


def _cost_to_go_gap(jcfg, u, pose_xyt, target, z):
    """|J − J'| of tpunav's and the port's float32 cost-to-go of one
    plain solve's rollouts, (N, K)."""
    u_pert = u[None] + z.transpose(0, 1)
    jl, _ = jm.rollout_losses(jcfg, jfs.MODEL, jnp.asarray(pose_xyt.numpy()),
                              jnp.asarray(u_pert.numpy()),
                              jnp.asarray(target.numpy()))
    tl, _ = t_rollout_losses(jcfg, tfs.MODEL, pose_xyt, u_pert, target)
    return np.abs(np.asarray(jm.cost_to_go(jl), np.float64)
                  - t_cost_to_go(tl).numpy().astype(np.float64))


def _solve_rows_match(jcfg, cfg, use_fused, solves, noises, target):
    """Each solve of the chunk, run by the port from tpunav's inputs (its
    u, its SLAM pose, its noise), against tpunav's update rows (cmd, then
    u_next[:-1]): a row may lie above U_BAR only at a near-tie of its
    float32 cost-to-go, or where the rounding of that cost-to-go covers
    the difference (chip_smoke.py's ``gate_rows``; for the plain solver
    with the packages' measured difference of J as the rounding where it
    is larger). Returns the exempt rows."""
    exempt = 0
    tgt = _t(target)
    for (u, pose_xyt, want), z in zip(solves, noises):
        if use_fused:
            cmd, un = t_fused(cfg, tfs.MODEL, u, 0, pose_xyt, tgt, noise=z)
        else:
            cmd, un = t_solve(cfg, tfs.MODEL, u, None, pose_xyt, tgt,
                              noise=z.transpose(0, 1))
        err = np.abs(torch.cat([cmd[None], un[:-1]]).numpy() - want)
        bad = (err > U_BAR).any(axis=1)
        if bad.any():
            dj = (None if use_fused
                  else _cost_to_go_gap(jcfg, u, pose_xyt, tgt, z))
            tie, slack = _rounding_slack(cfg, u, pose_xyt, tgt, z, dj)
            ok = tie | (err <= U_BAR + slack).all(axis=1)
            rows = np.nonzero(bad & ~ok)[0]
            assert not len(rows), (rows, err[rows], slack[rows])
            exempt += int(bad.sum())
    return exempt


def _scan_intervals(use_fused, graph):
    """Two scan intervals of the full stack at P=16, K=128, each from
    tpunav's state, through the eager stages or (``graph``) one injected
    ``ScanGraph`` loaded with that state; returns (label mismatches,
    exempt rows). See test_scan_intervals_match_tpunav."""
    seed, ticks = 5, 12
    pf_cfg, mppi_cfg, control_chunk, sense, slam_update = tfs.build(
        16, ticks, use_fused, seed, K, "cpu")
    jpf_cfg = jpf.PFConfig(num_particles=16, k_samples=50,
                           sample_range=(3e-5, 3e-4, 3e-4),
                           motion_noise=(1e-5, 1e-4, 1e-4),
                           grid=JGridConfig(), icp=JICPConfig(max_iter=25))
    assert interop.config_from_fields(
        PFConfig, dataclasses.asdict(jpf_cfg)) == pf_cfg
    jmppi = jm.MPPIConfig(**dataclasses.asdict(mppi_cfg))
    grid = pf_cfg.grid
    segs = jfs.make_world()
    rng = np.random.default_rng(11)
    pose0 = jnp.asarray([0.8, tfs.START_XY[0], tfs.START_XY[1]], F32)
    true = odom = slam = pose0
    jst = jpf.pf_init(jpf_cfg, pose=pose0, seed=seed)
    u = jm.init_controls(jmppi, dtype=F32)
    start = tfs.cell_of(grid, tfs.START_XY)
    goal = tfs.cell_of(grid, tfs.GOAL_XY)
    free = np.full((grid.height, grid.width), FREE, np.int8)
    planners = [j_dstar(free, start, goal), t_dstar(free, start, goal)]
    for p in planners:
        p.compute_shortest_path()
    step = jax.jit(lambda s, sc, ub, c, pr: jpf.pf_slam_step(
        jpf_cfg, s, sc, ub, c, pr, backend="xla"))
    runner = None

    mismatches, exempt = 0, 0
    for tick in range(2):
        path = planners[0].path_to_goal()
        assert [tuple(c) for c in planners[1].path_to_goal()] == \
            [tuple(c) for c in path]
        tx, ty = tfs.lookahead_target(grid, path)
        target = jnp.asarray([tx, ty, 0.0], F32)
        prev_odom = odom
        # The port's interval starts from tpunav's state.
        p_state = (_t(true), _t(odom), _t(slam), _t(u))
        p_pf = _port_pf(jst)
        noise_pf = _jax_noise(jpf_cfg, jst.key)

        true, odom, slam, u, noises, solves = _jax_chunk(
            jmppi, use_fused, true, odom, slam, u, target, tick, seed, rng,
            ticks)
        exempt += _solve_rows_match(jmppi, mppi_cfg, use_fused, solves,
                                    noises, target)
        key = jax.random.fold_in(jax.random.PRNGKey(tfs.SCAN_SEED), tick)
        scan = jlidar.scan_segments(true, segs, num_beams=grid.num_beams,
                                    max_range=grid.range_max, key=key,
                                    noise_std=0.002)
        scan_normals = _t(jax.random.normal(key, (grid.num_beams,), F32))
        u_body = jex.body_twist(odom, prev_odom)
        jst = step(jst, scan, u_body, odom, prev_odom)
        j_pose, j_grid = j_best(jst)

        if graph:
            if runner is None:
                stages = tfs.Stages(16, ticks, use_fused, seed, K, "cpu")
                runner = tfs.ScanGraph(stages, p_pf, p_state[0],
                                       p_state[3], "cpu", injected=True)
            capture.load(runner.carry, p_state)
            capture.load(runner.stepper.state, p_pf)
            runner.tick.fill_(tick)
            flat = torch.from_numpy(runner.scan(
                (tx, ty), noise=(noises, scan_normals, noise_pf)))
            p_true, p_odom = flat[3:6], runner.carry[1]
            p_scan = runner.stepper.inputs[0]
            p_pf, p_pose = runner.stepper.state, flat[:3]
            p_grid = flat[6:].reshape(grid.height, grid.width)
            chunk = []          # the graph keeps no chunk's SLAM pose
        else:
            p_true, p_odom, p_slam, _ = control_chunk(
                *p_state, _t(target), tick, noise=noises)
            p_scan = sense(p_true, noise=scan_normals)
            p_pf, p_pose, p_grid = slam_update(p_pf, p_scan, p_odom,
                                               p_state[1], noise=noise_pf)
            chunk = [("slam (chunk)", p_slam, slam)]
        for name, got, want in [("true", p_true, true), ("odom", p_odom, odom),
                                *chunk,
                                ("particles", p_pf.poses, jst.poses),
                                ("best particle", p_pose, j_pose)]:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=POSE_BAR,
                                       err_msg=f"scan {tick}: {name}")
        np.testing.assert_allclose(p_scan.numpy(), np.asarray(scan), rtol=0,
                                   atol=1e-5)

        j_lab = jfs.occupancy_to_labels(grid, np.asarray(j_grid))
        p_lab = tfs.occupancy_to_labels(grid, p_grid.numpy())
        l_occ = np.float32(grid.l_occ)
        near = ((np.abs(np.asarray(j_grid) - l_occ) < 1e-5)
                | (np.abs(p_grid.numpy() - l_occ) < 1e-5))
        differ = j_lab != p_lab
        # A differing label lies within the inflation of a near-l_occ cell.
        reach = binary_dilation(near, structure=np.ones((7, 7), bool))
        assert not (differ & ~reach).any(), \
            f"scan {tick}: {int((differ & ~reach).sum())} labels differ " \
            "away from l_occ"
        mismatches += int(differ.sum())
        for p, lab in zip(planners, (j_lab, p_lab)):
            lab[p.goal] = FREE
            p.observe(lab)
        slam = j_pose                  # the controller's next pose
        if not differ.any():
            got = [tuple(c) for c in planners[1].path_to_goal()]
            assert got == [tuple(c) for c in planners[0].path_to_goal()]
    assert np.isfinite(np.asarray(jst.poses)).all()
    return mismatches, exempt


@pytest.mark.parametrize("use_fused", [True, False])
def test_scan_intervals_match_tpunav(use_fused, record_property):
    """Two scan intervals of the full stack at P=16, K=128, each from
    tpunav's state: the control chunk with tpunav's noise, the scan with
    its range noise, pf_slam_step with its normals, then both packages'
    labels and D* Lite paths. Poses within 1e-5; labels equal but within
    the inflation (3 cells) of a cell whose log-odds lie within 1e-5 of
    l_occ in either package's grid (the mismatches are counted); paths
    equal where the labels are. The controls are held solve by solve,
    each from tpunav's inputs, at U_BAR but for near-tie rows of the
    λ = 0.01 softmax (ROADMAP.md §3; counted): chained over 12 solves, a
    near-tie row moves u by ~1e-3, which the next solve absorbs."""
    mismatches, exempt = _scan_intervals(use_fused, graph=False)
    record_property("label_mismatches", mismatches)
    record_property("near_tie_rows", exempt)


@pytest.mark.parametrize("use_fused", [True, False])
def test_graphed_scan_intervals_match_tpunav(use_fused, record_property):
    """The same two intervals through one ``ScanGraph`` (K1's or the plain
    solver's perturbations, the scan's normals and the filter's injected
    into its static tensors), loaded in place with tpunav's state before
    each: the true and odometry poses, the particles, the best particle
    and the scan at the same bars, the labels and paths as there."""
    mismatches, exempt = _scan_intervals(use_fused, graph=True)
    record_property("label_mismatches", mismatches)
    record_property("near_tie_rows", exempt)


@pytest.mark.parametrize("use_fused", [True, False])
def test_full_stack_graph_equals_eager(use_fused):
    """Four scans of ``run`` at P=8, K=64 through ``ScanGraph`` (the
    default) and through the eager stages: every trail pose, D* target
    and the final best grid bit for bit."""
    runs = [tfs.run(8, max_scans=4, use_fused=use_fused, verbose=False,
                    rollouts=64, device="cpu", eager=eager)
            for eager in (True, False)]
    assert runs[0]["updates"] == runs[1]["updates"] == 4
    assert set(runs[1]["ms_per_scan"]) == {"replay", "dstar_host", "whole"}
    for key in ("trail_true", "trail_slam", "targets", "grid", "stream"):
        np.testing.assert_array_equal(runs[1][key], runs[0][key],
                                      err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dstar_planners_agree_on_a_label_sequence(seed):
    """Both packages' D* Lite fed the same sequence of growing obstacle
    maps, as the full stack feeds them, give the same paths."""
    grid = tfs.configs()[0].grid
    rng = np.random.default_rng(seed)
    start = tfs.cell_of(grid, tfs.START_XY)
    goal = tfs.cell_of(grid, tfs.GOAL_XY)
    labels = np.full((grid.height, grid.width), FREE, np.int8)
    planners = [j_dstar(labels, start, goal), t_dstar(labels, start, goal)]
    for p in planners:
        p.compute_shortest_path()
    occ = np.zeros(labels.shape, bool)
    for step in range(6):
        y, x = rng.integers(0, grid.height - 8, size=2)
        occ[y:y + rng.integers(2, 8), x:x + rng.integers(2, 8)] = True
        log_odds = np.where(occ, 3.0, -1.0).astype(np.float32)
        paths = []
        for p, fn in zip(planners, (jfs.occupancy_to_labels,
                                    tfs.occupancy_to_labels)):
            lab = fn(grid, log_odds)
            lab[p.goal] = FREE
            p.observe(lab)
            p.pos = tuple(int(v) for v in p.path_to_goal()[min(step, 1)])
            paths.append([tuple(int(v) for v in c)
                          for c in p.path_to_goal()])
        assert paths[0] == paths[1], f"step {step}"
        assert len(paths[0]) > 1
