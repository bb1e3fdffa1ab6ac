"""The port's RBPF grid SLAM (the slice as a whole) against ``tpunav``.

Angles and SE(2), ICP (the cases of tests/test_rbpf.py), the particle
filter's pieces, and one full ``pf_slam_step``: ``tpunav``'s step runs
from a state carried across with ``tpunav_torch.interop``, the test
replays its key splits in jax and hands the normals to the port through
``noise=``, and the results are held to the bars of
tests/test_pallas_rbpf.py. On the CPU the port's step runs the plain
versions of kernels K2 and K3. Also the port's own closed loop in a box
world, judged by outcome, and the guards of the slice: every entry point
defaults to the card and raises without CUDA.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.core import angles as jangles
from tpunav.core import se2 as jse2
from tpunav.estimation.rbpf import PFConfig as JPFConfig
from tpunav.estimation.rbpf import grid as jg
from tpunav.estimation.rbpf import icp as jicp
from tpunav.estimation.rbpf import particle_filter as jpf
from tpunav.sim import lidar as jlidar
from tpunav_torch import interop
from tpunav_torch.core import angles, se2
from tpunav_torch.estimation.rbpf import (GridConfig, PFConfig, best_particle,
                                          pf_init, pf_slam_step)
from tpunav_torch.estimation.rbpf import grid as tg
from tpunav_torch.estimation.rbpf import icp as ticp
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.sim import lidar as tlidar

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = jnp.float32
SMALL = dict(resolution=0.1, num_beams=90, beam_delta=2 * math.pi / 90)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------ angles and SE(2) ---

def test_angles_match_tpunav():
    x = np.concatenate([np.linspace(-20.0, 20.0, 401),
                        [math.pi, -math.pi, 3 * math.pi, 0.0]])
    for ours, theirs in [(angles.normalize_angle_pi,
                          jangles.normalize_angle_pi),
                         (angles.normalize_angle_2pi,
                          jangles.normalize_angle_2pi)]:
        np.testing.assert_allclose(ours(_t(x)).numpy(),
                                   np.asarray(theirs(jnp.asarray(x))),
                                   rtol=0, atol=1e-12)
    assert float(angles.normalize_angle_pi(
        torch.tensor(math.pi, dtype=torch.float64))) == -math.pi
    assert angles.deg2rad(180.0) == math.pi
    assert bool(angles.almost_equal(1.0, 1.0 + 1e-13))


def test_se2_matches_tpunav():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 6, 3))
    v = rng.normal(size=(6, 3))
    v[0, 0] = 1e-8                                  # the Taylor branch
    p = rng.normal(size=(6, 2))
    cases = [(se2.compose(_t(a), _t(b)), jse2.compose(a, b)),
             (se2.inverse(_t(a)), jse2.inverse(a)),
             (se2.apply(_t(a), _t(p)), jse2.apply(a, p)),
             (se2.adjoint(_t(a), _t(v)), jse2.adjoint(a, v)),
             (se2.exp_twist(_t(v)), jse2.exp_twist(v)),
             (se2.integrate_twist(_t(a), _t(v)), jse2.integrate_twist(a, v)),
             (se2.log_twist(_t(a)), jse2.log_twist(a))]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(
        se2.compose(_t(a), se2.inverse(_t(a))).numpy()[:, 1:], 0.0,
        atol=1e-12)


# ------------------------------------------------------------------ ICP ---

def _box_scan(pose, half=1.5):
    segs = jlidar.box_segments(-half, -half, half, half, jnp.float64)
    return np.array(jlidar.scan_segments(jnp.asarray(pose, jnp.float64),
                                         segs))


def _icp_both(src, src_ok, dst, dst_ok, guess=np.zeros(3), **kw):
    """Both packages' ICP on the same float64 clouds."""
    jres = jicp.icp_match(jicp.ICPConfig(**kw), jnp.asarray(src),
                          jnp.asarray(src_ok), jnp.asarray(dst),
                          jnp.asarray(dst_ok), jnp.asarray(guess))
    tres = ticp.icp_match(ticp.ICPConfig(**kw), _t(src), _t(src_ok), _t(dst),
                          _t(dst_ok), _t(guess))
    np.testing.assert_allclose(tres.transform.numpy(),
                               np.asarray(jres.transform), rtol=0, atol=1e-4)
    assert bool(tres.converged) == bool(jres.converged)
    for name in ("rmse", "inlier_frac", "normal_eig"):
        np.testing.assert_allclose(float(getattr(tres, name)),
                                   float(getattr(jres, name)), atol=1e-4)
    return tres


def _clouds(pose_a, pose_b, **kw):
    def pts(scan):
        p, ok = jicp.scan_to_points(jnp.asarray(scan), 0.12, 3.5)
        return np.asarray(p), np.asarray(ok)
    src, src_ok = pts(_box_scan(pose_b, **kw))
    dst, dst_ok = pts(_box_scan(pose_a, **kw))
    return src, src_ok, dst, dst_ok


def test_scan_to_points_matches_tpunav():
    scan = _box_scan([0.05, 0.08, -0.03])
    scan[:5] = 0.05                                  # below range_min
    p, ok = ticp.scan_to_points(_t(scan), 0.12, 3.5)
    jp, jok = jicp.scan_to_points(jnp.asarray(scan), 0.12, 3.5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-12)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_icp_recovers_known_transform():
    pose_b = np.array([0.05, 0.08, -0.03])
    res = _icp_both(*_clouds(np.zeros(3), pose_b))
    assert bool(res.converged)
    np.testing.assert_allclose(res.transform.numpy(), pose_b, atol=0.02)


def test_icp_fails_on_garbage():
    rng = np.random.default_rng(0)
    src = rng.uniform(-2, 2, (90, 2))
    dst = rng.uniform(-2, 2, (90, 2))
    ok = np.ones(90, bool)
    assert not bool(_icp_both(src, ok, dst, ok).converged)


def test_icp_robust_to_outliers():
    pose_b = np.array([0.04, 0.06, -0.04])
    src, src_ok, dst, dst_ok = _clouds(np.zeros(3), pose_b)
    rng = np.random.default_rng(3)
    n = src.shape[0]
    idx = rng.choice(n, size=n // 4, replace=False)
    src = src.copy()
    src[idx] = rng.uniform(-1.3, 1.3, size=(n // 4, 2))
    res = _icp_both(src, src_ok, dst, dst_ok)
    assert bool(res.converged)
    np.testing.assert_allclose(res.transform.numpy(), pose_b, atol=0.02)


def test_icp_partial_overlap():
    pose_b = np.array([0.05, 0.05, 0.03])
    src, src_ok, dst, dst_ok = _clouds(np.zeros(3), pose_b)
    dst_ok = dst_ok.copy()
    dst_ok[:108] = False                              # 30% of 360 beams gone
    res = _icp_both(src, src_ok, dst, dst_ok)
    assert bool(res.converged)
    np.testing.assert_allclose(res.transform.numpy(), pose_b, atol=0.02)


def test_icp_corridor_reports_nonconvergence():
    segs = jnp.asarray([[-20.0, -0.5, 20.0, -0.5],
                        [-20.0, 0.5, 20.0, 0.5]], jnp.float64)

    def pts(pose):
        scan = jlidar.scan_segments(jnp.asarray(pose, jnp.float64), segs)
        p, ok = jicp.scan_to_points(scan, 0.12, 3.5)
        return np.asarray(p), np.asarray(ok)
    res = _icp_both(*pts([0.0, 0.3, 0.0]), *pts([0.0, 0.0, 0.0]))
    assert float(res.normal_eig) < ticp.ICPConfig().min_normal_eig
    assert not bool(res.converged)


# ------------------------------------------------------- particle filter ---

def _cfgs(p=4, k=6, max_iter=15, grid=SMALL):
    kw = dict(num_particles=p, k_samples=k, sample_range=(1e-6, 1e-5, 1e-5),
              motion_noise=(1e-6, 1e-5, 1e-5))
    jcfg = JPFConfig(grid=jg.GridConfig(**grid),
                     icp=jicp.ICPConfig(max_iter=max_iter), **kw)
    tcfg = interop.config_from_fields(PFConfig, dataclasses.asdict(jcfg))
    return jcfg, tcfg


def _jax_noise(jcfg, key):
    """The normals tpunav's pf_slam_step draws from ``key``
    (particle_filter.py:250-251, :176-182, :205, :106, :218)."""
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


@pytest.mark.parametrize("backend,has_prev", [("pallas-interpret", True),
                                              ("xla", True),
                                              ("pallas-interpret", False)])
def test_pf_step_matches_tpunav(backend, has_prev):
    """One update from a mapped state (ICP proposal branch) and from a
    first scan (motion-model branch), with tpunav's normals injected; the
    bars of tests/test_pallas_rbpf.py:161-166."""
    jcfg, tcfg = _cfgs()
    segs = jlidar.box_segments(-1.5, -1.5, 1.5, 1.5, F32)
    u = jnp.array([0.02, 0.01], F32)
    pose = jnp.array([0.02, 0.01, 0.0], F32)
    scan = jlidar.scan_segments(pose, segs, num_beams=jcfg.grid.num_beams,
                                beam_delta=jcfg.grid.beam_delta,
                                max_range=jcfg.grid.range_max)
    st0 = jpf.pf_init(jcfg, seed=3)
    grids = jax.vmap(lambda g: jg.integrate_scan(jcfg.grid, g, scan, pose)
                     )(st0.grids)
    st0 = st0._replace(grids=grids,
                       dists=jax.vmap(lambda g: jg.esdf(jcfg.grid, g))(grids),
                       prev_scan=scan, has_prev=jnp.asarray(has_prev))
    odom0 = jnp.zeros(3, F32)
    want = jpf.pf_slam_step(jcfg, st0, scan, u, pose, odom0, backend=backend)

    st = interop.pf_state_from_numpy(
        {name: np.asarray(getattr(st0, name)) for name in _STATE},
        device="cpu")
    got = pf_slam_step(tcfg, st, _t(scan), _t(u), _t(pose), _t(odom0),
                       noise=_jax_noise(jcfg, st0.key))
    got = interop.pf_state_to_numpy(got)
    np.testing.assert_allclose(got["poses"], np.asarray(want.poses),
                               atol=1e-3)
    np.testing.assert_allclose(got["log_weights"],
                               np.asarray(want.log_weights), atol=0.05)
    np.testing.assert_allclose(got["grids"], np.asarray(want.grids),
                               atol=1e-3)
    np.testing.assert_allclose(got["dists"], np.asarray(want.dists),
                               atol=1e-3)
    np.testing.assert_array_equal(got["prev_scan"], np.asarray(scan))
    assert bool(got["has_prev"])


def test_filter_pieces_match_tpunav():
    """Odometry likelihood, motion model, ICP guess, proposal fit and the
    resample index, each on the same float64 inputs."""
    jcfg, tcfg = _cfgs(p=5, k=7)
    rng = np.random.default_rng(4)
    poses = rng.normal(scale=0.3, size=(5, 3))
    samples = poses[:, None, :] + rng.normal(scale=0.01, size=(5, 7, 3))
    cur, prev = np.array([0.1, 0.05, 0.02]), np.array([0.05, 0.0, 0.01])
    got = tpf.pose_likelihood_odom(tcfg, _t(samples), _t(poses)[:, None],
                                   _t(cur), _t(prev)).numpy()
    for i in range(5):
        want = jax.vmap(lambda s: jpf.pose_likelihood_odom(
            jcfg, s, jnp.asarray(poses[i]), jnp.asarray(cur),
            jnp.asarray(prev)))(jnp.asarray(samples[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(
        tpf._icp_init_guess(_t(cur), _t(prev)).numpy(),
        np.asarray(jpf._icp_init_guess(jnp.asarray(cur), jnp.asarray(prev))),
        atol=1e-12)

    key = jax.random.PRNGKey(5)
    u = np.array([0.03, 0.02])
    normals = np.asarray(jax.random.normal(key, (3,), jnp.float64))
    got = tpf._sample_motion_model(tcfg, _t(poses), _t(u),
                                   _t(np.tile(normals, (5, 1))))
    for i in range(5):
        want = jpf._sample_motion_model(jcfg, jnp.asarray(poses[i]),
                                        jnp.asarray(u), key)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=1e-12)

    logp = rng.normal(scale=2.0, size=(5, 7))
    z = rng.normal(size=(5, 3))
    new, log_eta = tpf._gaussian_from_samples(
        tcfg, _t(samples), _t(logp), _t(poses), _t(cur), _t(prev), _t(z))
    for i in range(5):
        mu_j, eta_j = _j_gaussian(jcfg, samples[i], logp[i], poses[i], cur,
                                  prev, z[i])
        np.testing.assert_allclose(new[i].numpy(), mu_j, atol=1e-9)
        np.testing.assert_allclose(float(log_eta[i]), eta_j, atol=1e-9)

    lw = rng.normal(scale=3.0, size=5)
    st = jpf.pf_init(jcfg, seed=0)._replace(log_weights=jnp.asarray(lw),
                                            poses=jnp.asarray(poses))
    want = jpf._low_variance_resample(jcfg, st, key)
    idx = tpf._resample_index(tcfg, _t(lw),
                              _t(jax.random.normal(key, (), jnp.float64)))
    np.testing.assert_allclose(poses[idx.numpy()], np.asarray(want.poses),
                               atol=0)


def test_failed_proposal_factor_gives_nan_as_tpunav():
    """A degenerate σ whose Cholesky factor fails: tpunav's
    ``jnp.linalg.cholesky`` gives NaN, so that particle's new pose is NaN;
    the port's proposal gives NaN in exactly the same rows and the same
    finite rows elsewhere (float32, as the filter runs)."""
    jcfg, tcfg = _cfgs(p=4, k=6)
    rng = np.random.default_rng(8)
    poses = rng.normal(scale=0.3, size=(4, 3)).astype(np.float32)
    samples = (poses[:, None, :] + rng.normal(scale=0.01, size=(4, 6, 3))
               ).astype(np.float32)
    # Particles 1 and 3: heading fixed, x and y moving together by ±0.5 —
    # σ = [[0, 0, 0], [0, ¼, ¼], [0, ¼, ¼]] exactly, so the factor's last
    # pivot is 0 and the factor fails. Every weight clamps alike (the scan
    # term at its max, the odometry term far off at its min).
    for i in (1, 3):
        samples[i] = 0.0
        samples[i, :, 1] = np.tile([0.5, -0.5], 3)
        samples[i, :, 2] = samples[i, :, 1]
    logp = np.full((4, 6), 10.0, np.float32)
    cur = np.array([0.0, 50.0, 50.0], np.float32)
    prev = np.array([0.0, 50.0, 49.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.stack([np.asarray(jpf._gaussian_from_samples(
        jcfg, jnp.asarray(samples[i]), jnp.asarray(logp[i]),
        jnp.asarray(poses[i]), jnp.asarray(cur), jnp.asarray(prev),
        keys[i])[0]) for i in range(4)])
    z = np.stack([np.asarray(jax.random.normal(k, (3,), F32)) for k in keys])
    got, _ = tpf._gaussian_from_samples(
        tcfg, _t(samples), _t(logp), _t(poses), _t(cur), _t(prev), _t(z))
    got = got.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got).all(1), [False, True,
                                                         False, True])
    np.testing.assert_array_equal(np.isnan(want).all(1), np.isnan(got).all(1))
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=1e-5)


def _j_gaussian(jcfg, samples, logp, pose, cur, prev, z):
    """tpunav's _gaussian_from_samples with the final normal ``z`` in place
    of its key's draw."""
    p_scan = np.clip(np.exp(np.clip(logp, -60.0, 60.0)), jcfg.scan_lik_min,
                     jcfg.scan_lik_max)
    p_pose = np.clip(np.asarray(jax.vmap(lambda s: jpf.pose_likelihood_odom(
        jcfg, s, jnp.asarray(pose), jnp.asarray(cur), jnp.asarray(prev)))(
            jnp.asarray(samples))), jcfg.pose_lik_min, jcfg.pose_lik_max)
    p = p_scan * p_pose
    eta = p.sum()
    mu = (samples * p[:, None]).sum(0) / eta
    mu[0] = float(jangles.normalize_angle_pi(mu[0]))
    diff = samples - mu
    sigma = np.einsum("ki,kj,k->ij", diff, diff, p) / eta
    new = mu + np.linalg.cholesky(sigma + 1e-12 * np.eye(3)) @ z
    new[0] = float(jangles.normalize_angle_pi(new[0]))
    return new, math.log(eta)


def test_pf_closed_loop_box_world():
    """tests/test_rbpf.py:258 through the port: exact odometry, a noisy
    filter, 25 updates; judged by outcome."""
    _, cfg = _cfgs(p=8, k=10, max_iter=20)
    segs = tlidar.box_segments(-1.5, -1.5, 1.5, 1.5, device="cpu")
    u = torch.tensor([0.02, 0.01])
    st = pf_init(cfg, seed=1, device="cpu")
    true_pose = torch.zeros(3)
    prev_odom = true_pose
    for _ in range(25):
        th = true_pose[0] + u[0]
        true_pose = torch.stack([th, true_pose[1] + u[1] * torch.cos(th),
                                 true_pose[2] + u[1] * torch.sin(th)])
        scan = tlidar.scan_segments(true_pose, segs,
                                    num_beams=cfg.grid.num_beams,
                                    beam_delta=cfg.grid.beam_delta,
                                    max_range=cfg.grid.range_max)
        st = pf_slam_step(cfg, st, scan, u, true_pose, prev_odom)
        prev_odom = true_pose
    pose, grid = best_particle(st)
    err = float(torch.linalg.norm(pose[1:] - true_pose[1:]))
    assert err < 0.15, f"pose error {err}, pose={pose}"
    occ = (grid >= cfg.grid.l_occ).numpy()
    assert occ.sum() > 20, f"too few occupied cells: {occ.sum()}"
    iy, ix = tg.world_to_cell(cfg.grid, torch.tensor([1.5, 0.0]))
    assert occ[int(iy) - 1:int(iy) + 2, :].any(), "east wall not mapped"
    assert torch.isfinite(st.log_weights).all()
    assert float(torch.exp(st.log_weights).sum()) > 0.1


def test_pf_resampling_concentrates_weight():
    _, cfg = _cfgs(p=8, k=10)
    st = pf_init(cfg, seed=0, device="cpu")
    lw = torch.full((8,), -1e3)
    lw[3] = 0.0
    st = st._replace(log_weights=lw - torch.logsumexp(lw, 0),
                     poses=torch.arange(24.0).reshape(8, 3))
    out = tpf._low_variance_resample(cfg, st, torch.tensor(0.3))
    matches = (out.poses == st.poses[3]).all(1)
    assert int(matches.sum()) >= 6, matches


# --------------------------------------------------------------- interop ---

def test_config_from_fields_builds_nested_configs():
    jcfg, tcfg = _cfgs()
    assert isinstance(tcfg.grid, GridConfig)
    assert isinstance(tcfg.icp, ticp.ICPConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for ours, theirs in [(PFConfig, JPFConfig), (GridConfig, jg.GridConfig),
                         (ticp.ICPConfig, jicp.ICPConfig)]:
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_pf_state_round_trip():
    _, cfg = _cfgs()
    st = pf_init(cfg, pose=[0.1, 0.2, 0.3], seed=4, device="cpu")
    back = interop.pf_state_from_numpy(interop.pf_state_to_numpy(st),
                                       device="cpu", seed=4)
    for name, val in interop.pf_state_to_numpy(back).items():
        ref = getattr(st, name)
        assert getattr(back, name).dtype == ref.dtype
        np.testing.assert_array_equal(val, ref.numpy())
    assert torch.equal(torch.randn(3, generator=back.generator),
                       torch.randn(3, generator=st.generator))


def test_lidar_yaml_loads_equal_in_both_packages():
    from tpunav.runtime.config import load_lidar_config as j_load
    from tpunav_torch.runtime.config import load_lidar_config

    path = os.path.join(REPO, "configs", "lds01_lidar.yaml")
    got, want = load_lidar_config(path), j_load(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_beams == 360
    assert got.beam_delta_rad == GridConfig().beam_delta


# ---------------------------------------------------------------- guards ---

def _entry_points():
    from tpunav_torch.control import mppi
    from tpunav_torch.control.slam_loop import slam_batch_init
    from tpunav_torch.control.waypoint_loop import course_init
    from tpunav_torch.estimation.ekf import EKFConfig
    from tpunav_torch.parallel import pf_init_sharded, rollout_mesh

    cfg = mppi.MPPIConfig(horizon=0.1)
    pcfg = PFConfig(num_particles=2, k_samples=2, grid=GridConfig(**SMALL))
    return {
        "init_controls": lambda: mppi.init_controls(cfg),
        "sample_perturbations": lambda: mppi.sample_perturbations(
            cfg, torch.Generator()),
        "MPPIController": lambda: mppi.MPPIController(
            cfg, mppi.CartParams(0.033, 0.16)),
        "course_init": lambda: course_init(cfg, [0.0, 0.0, 0.0]),
        "slam_batch_init": lambda: slam_batch_init(
            cfg, EKFConfig(num_landmarks=2), [0, 1]),
        "course_state_from_numpy": lambda: interop.course_state_from_numpy(
            {n: np.zeros(()) for n in ("pose", "u", "wpt_idx", "visits",
                                       "ticks", "done", "wheel_vel")}),
        "pf_init": lambda: pf_init(pcfg),
        "grid_init": lambda: tg.grid_init(pcfg.grid),
        "box_segments": lambda: tlidar.box_segments(-1, -1, 1, 1),
        "pf_state_from_numpy": lambda: interop.pf_state_from_numpy(
            {n: np.zeros(()) for n in _STATE}),
        "se2.identity": lambda: se2.identity(),
        "rollout_mesh": lambda: rollout_mesh(),
        "pf_init_sharded": lambda: pf_init_sharded(
            pcfg, rollout_mesh(device="cpu")),
        **_graph_entry_points(pcfg),
        **_node_entry_points(pcfg),
        **_demo_entry_points(),
    }


def _graph_entry_points(pcfg):
    """The constructors of the CUDA-graph paths (``tpunav_torch.capture``):
    each defaults to the card, even given a state on the CPU."""
    from tpunav_torch import capture
    from tpunav_torch.estimation.ekf import filter as ekf

    ecfg = ekf.EKFConfig(num_landmarks=2, spd_repair=False)
    rcfg = ekf.EKFConfig(num_landmarks=2)          # the default SPD repair
    pcfg_ = ekf.EKFConfig(num_landmarks=2, spd_repair_per_meas=True)
    return {
        "capture.Graph": lambda: capture.Graph(lambda: None),
        "PFStepper": lambda: tpf.PFStepper(pcfg, pf_init(pcfg,
                                                         device="cpu")),
        "EKFStepper": lambda: ekf.EKFStepper(
            ecfg, ekf.ekf_init(ecfg, device="cpu"), 2),
        "EKFStepper(spd_repair)": lambda: ekf.EKFStepper(
            rcfg, ekf.ekf_init(rcfg, device="cpu"), 2),
        "EKFStepper(spd_repair_per_meas)": lambda: ekf.EKFStepper(
            pcfg_, ekf.ekf_init(pcfg_, device="cpu"), 2, known_da=False),
        "EKFStepper(seed batch)": lambda: ekf.EKFStepper(ecfg, ekf.EKFState(
            *(t.expand(3, *t.shape).clone()
              for t in ekf.ekf_init(ecfg, device="cpu"))), 2),
        **_demo_graph_entry_points(ecfg, ekf.ekf_init(
            ecfg, dtype=torch.float32, device="cpu")),
        **_sharded_graph_entry_points(pcfg),
    }


def _sharded_graph_entry_points(pcfg):
    """The graphed sharded steppers (``tpunav_torch.parallel``) on the
    one-shard CPU mesh, given their state on the CPU and no device."""
    from tpunav_torch.control import mppi
    from tpunav_torch.parallel import (FusedShardedStepper,
                                       PlainShardedStepper, ShardedPFStepper,
                                       pf_init_sharded, rollout_mesh)

    cfg = mppi.MPPIConfig(horizon=0.1)
    model = mppi.CartParams(0.033, 0.16)

    def mesh():
        return rollout_mesh(device="cpu")

    def u():
        return mppi.init_controls(cfg, device="cpu")

    return {
        "FusedShardedStepper": lambda: FusedShardedStepper(
            cfg, model, mesh(), u(), 0),
        "PlainShardedStepper": lambda: PlainShardedStepper(
            cfg, model, mesh(), u(), torch.Generator()),
        "ShardedPFStepper": lambda: ShardedPFStepper(
            pcfg, mesh(), pf_init_sharded(pcfg, mesh(), device="cpu")),
    }


def _demo_graph_entry_points(ecfg, ekf_state):
    """The demos' graphed runners (``examples_torch/``), each given a
    state on the CPU and no device."""
    from examples_torch import full_stack_demo as fs
    from examples_torch import lidar_ekf_slam_demo as le
    from examples_torch import rbpf_explore_demo as ex
    from tpunav_torch.estimation.ekf import filter as ekf

    def explore():
        pf_cfg, mppi_cfg = ex.configs(2, 32)
        return ex.ScanGraph(pf_cfg, mppi_cfg, ex.init_state(
            pf_cfg, mppi_cfg, device="cpu"))

    def full_stack():
        stages = fs.Stages(2, 1, False, rollouts=32, device="cpu")
        pose = torch.zeros(3)
        return fs.ScanGraph(stages, pf_init(stages.pf_cfg, device="cpu"),
                            pose, torch.zeros(stages.mppi_cfg.steps, 2))

    def ekf_step():
        z = torch.zeros(2)
        return le.StepGraph(ecfg, True, lambda pose, n: n, (2, 2), 2,
                            ekf_state, z, z)

    def ekf_step_batch():
        z = torch.zeros(2)
        return le.StepGraph(ecfg, True, lambda pose, n: n, (2, 2), 2,
                            ekf.EKFState(*(t.expand(3, *t.shape).clone()
                                           for t in ekf_state)), z, z)

    def chained():
        from examples_torch.profile_rbpf_stages import ChainedStages

        pf_cfg, mppi_cfg = ex.configs(2, 32)
        return ChainedStages(pf_cfg, mppi_cfg, ex.init_state(
            pf_cfg, mppi_cfg, device="cpu"))

    return {"examples_torch.rbpf_explore_demo.ScanGraph": explore,
            "examples_torch.full_stack_demo.ScanGraph": full_stack,
            "examples_torch.lidar_ekf_slam_demo.StepGraph": ekf_step,
            "examples_torch.lidar_ekf_slam_demo.StepGraph(seed batch)":
                ekf_step_batch,
            "examples_torch.profile_rbpf_stages.ChainedStages": chained}


def _node_entry_points(pcfg):
    """The runtime's node constructors that create state on a device."""
    from tpunav_torch.core import diff_drive as dd
    from tpunav_torch.estimation.ekf import EKFConfig
    from tpunav_torch.estimation.landmarks import LandmarkConfig
    from tpunav_torch.runtime import nodes, slam_nodes
    from tpunav_torch.runtime.channels import Channel
    from tpunav_torch.planning import PotentialField, PotentialFieldConfig
    from tpunav_torch.planning.world import load_obstacle_map
    from tpunav_torch.sim.tsim import TurtleWay

    p = dd.TURTLEBOT3

    def ch(n):
        return [Channel() for _ in range(n)]

    return {
        "OdometerNode": lambda: nodes.OdometerNode(p, *ch(2)),
        "FakeDiffEncodersNode": lambda: nodes.FakeDiffEncodersNode(p, *ch(2)),
        "TurtleInterfaceNode": lambda: nodes.TurtleInterfaceNode(p, *ch(4)),
        "LandmarksNode": lambda: slam_nodes.LandmarksNode(LandmarkConfig(),
                                                          *ch(2)),
        "EkfSlamNode": lambda: slam_nodes.EkfSlamNode(EKFConfig(), p,
                                                      *ch(4)),
        "RbpfMappingNode": lambda: slam_nodes.RbpfMappingNode(pcfg, p,
                                                              *ch(4)),
        "TurtleWay": lambda: TurtleWay([(0.0, 0.0), (1.0, 0.0)], 1.0, 0.5,
                                       60.0, *ch(2)),
        "PotentialField": lambda: PotentialField(
            PotentialFieldConfig(), load_obstacle_map(
                [[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]], [[-1, 2], [-1, 2]])),
    }


def _demo_entry_points():
    """The demos' run-style functions (``examples_torch/``)."""
    from examples_torch import (dense_world_slam_demo, ekf_slam_demo,
                                full_stack_demo, launch, lidar_ekf_slam_demo,
                                live_view_demo, make_results,
                                mppi_two_process, mppi_waypoints_demo,
                                obstacle_mppi_demo, planners_demo,
                                profile_rbpf_stages, rbpf_explore_demo,
                                rbpf_slam_demo, rbpf_two_process,
                                seed_batch_sweeps,
                                slam_mppi_closed_loop_demo)

    ex, fs, le = rbpf_explore_demo, full_stack_demo, lidar_ekf_slam_demo
    step, known, ekf_cfg = le.CONFIGS["known"]
    return {f"examples_torch.{name}": fn for name, fn in {
        "rbpf_explore_demo.build": lambda: ex.build(2, 1, 32),
        "rbpf_explore_demo.init_state": lambda: ex.init_state(
            *ex.configs(2, 32)),
        "rbpf_explore_demo.run_experiment": lambda: ex.run_experiment(2, 1,
                                                                      32),
        "rbpf_explore_demo.seed_sweep": lambda: ex.seed_sweep((0,), 2),
        "full_stack_demo.make_world": lambda: fs.make_world(),
        "full_stack_demo.build": lambda: fs.build(2),
        "full_stack_demo.run": lambda: fs.run(2, max_scans=1),
        "lidar_ekf_slam_demo.make_sim": lambda: le.make_sim(step, ekf_cfg,
                                                            known, 1),
        "lidar_ekf_slam_demo.run": lambda: le.run(step, ekf_cfg, known, 1),
        "lidar_ekf_slam_demo.run_many": lambda: le.run_many(
            step, ekf_cfg, known, [0], 1),
        "lidar_ekf_slam_demo.make_sim_batch": lambda: le.make_sim_batch(
            step, ekf_cfg, known, 2, 1),
        "dense_world_slam_demo.build": lambda: dense_world_slam_demo.build(1),
        "dense_world_slam_demo.run": lambda: dense_world_slam_demo.run(
            steps=1),
        "dense_world_slam_demo.run_batch":
            lambda: dense_world_slam_demo.run_batch([0], 1),
        "dense_world_slam_demo.build_batch":
            lambda: dense_world_slam_demo.build_batch(1),
        "seed_batch_sweeps.serial":
            lambda: seed_batch_sweeps.serial(3, [0], ticks=1, rollouts=32),
        "seed_batch_sweeps.main":
            lambda: seed_batch_sweeps.main(["--rows", "1", "--seeds", "1"]),
        "slam_mppi_closed_loop_demo.run":
            lambda: slam_mppi_closed_loop_demo.run(
                "x", slam_mppi_closed_loop_demo.block_world(), True, 12),
        "mppi_waypoints_demo.run": lambda: mppi_waypoints_demo.run(True, 32),
        "obstacle_mppi_demo.run": lambda: obstacle_mppi_demo.run(32),
        "ekf_slam_demo.run": lambda: ekf_slam_demo.run(
            *ekf_slam_demo.CONFIGS["known-DA "], steps=1),
        "rbpf_slam_demo.course_inputs": lambda: rbpf_slam_demo.course_inputs(
            GridConfig(**SMALL), 1),
        "rbpf_slam_demo.run": lambda: rbpf_slam_demo.run(2, 1),
        "planners_demo.run_dstar": lambda: planners_demo.run_dstar(),
        "planners_demo.run_potential_field":
            lambda: planners_demo.run_potential_field(),
        "live_view_demo.build": lambda: live_view_demo.build("x.png"),
        "live_view_demo.build_rbpf": lambda: live_view_demo.build_rbpf(
            "x.png"),
        "profile_rbpf_stages.stage_times":
            lambda: profile_rbpf_stages.stage_times(2),
        "profile_rbpf_stages.profile_closed_loop":
            lambda: profile_rbpf_stages.profile_closed_loop(2, 1, 32),
        "make_results.main": lambda: make_results.main(["--rows", "1"]),
        "full_stack_demo.Stages": lambda: fs.Stages(2),
        "ekf_slam_demo.make_course": lambda: ekf_slam_demo.make_course(
            *ekf_slam_demo.CONFIGS["known-DA "], steps=1),
        "rbpf_slam_demo.course": lambda: rbpf_slam_demo.course(
            rbpf_slam_demo.config(2), rbpf_slam_demo.course_inputs(
                GridConfig(**SMALL), 1, device="cpu")),
        "launch": lambda: launch(_no_target),
        "mppi_two_process.launcher": lambda: mppi_two_process.launcher(),
        "rbpf_two_process.launcher": lambda: rbpf_two_process.launcher(),
    }.items()}


def _no_target(mesh, device):
    raise AssertionError("a rank was spawned")


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Without a device argument every entry point asks for CUDA, and raises
    where there is none rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_se2_identity_on_the_cpu_matches_tpunav():
    """Asked for the CPU, ``identity`` is ``tpunav``'s zero (3,) transform
    [θ, x, y], in float32 by default and in the dtype asked for."""
    got = se2.identity(device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jse2.identity()))
    wide = se2.identity(torch.float64, device="cpu")
    assert wide.dtype == torch.float64 and wide.shape == (3,)
    assert not bool(wide.any())
