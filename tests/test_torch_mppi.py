"""The port's plain MPPI path against ``tpunav`` on the CPU.

Cart, RK4 and the plain solver of ``tpunav_torch`` run beside their
``tpunav`` counterparts on the same numpy inputs and noise. Each test
states its dtype: tests/conftest.py runs jax in x64, so f32 cases build
the jax inputs as explicit float32. Also the guards of the package: no jax
at import, no fallback when the kernels cannot be built, and the same
``mppi_params.yaml`` fields in both packages.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav import native
from tpunav.control import mppi as jm
from tpunav.models.cart import CartParams as JCartParams
from tpunav.models.cart import kinematic_cart as j_cart
from tpunav.ops.rk4 import rk4_solve as j_rk4_solve
from tpunav.ops.rk4 import rk4_step as j_rk4_step
from tpunav_torch.control import mppi as tm
from tpunav_torch.models.cart import CartParams, kinematic_cart
from tpunav_torch.ops.rk4 import rk4_solve, rk4_solve_autonomous, rk4_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = CartParams(0.033, 0.160)
J_MODEL = JCartParams(0.033, 0.160)
POSE = np.array([0.1, -0.2, 0.3])
XD = np.array([1.0, 1.0, 0.0])


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _cfg(k, n, **kw):
    return dict(horizon=n * 0.01, dt=0.01, rollouts=k, **kw)


# ------------------------------------------------------ cart and RK4 ----

def test_cart_matches_tpunav_f64():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 3))
    u = rng.normal(size=(7, 2)) * 3.0
    got = kinematic_cart(MODEL, _t(x), _t(u)).numpy()
    want = np.asarray(j_cart(J_MODEL, jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_rk4_matches_exact_circle_f64():
    # Constant wheel speeds → constant (v, w) → exact circular arc.
    ul, ur = 1.0, 2.0
    r, b = 0.033, 0.160
    v = r / 2 * (ul + ur)
    w = r / b * (ur - ul)
    dt, n = 0.01, 100
    us = torch.tensor([ul, ur], dtype=torch.float64).expand(n, 2)
    f = lambda x, u: kinematic_cart(MODEL, x, u)
    traj = rk4_solve(f, torch.zeros(3, dtype=torch.float64), us, dt)
    t = dt * n
    exact = np.array([v / w * np.sin(w * t), v / w * (1 - np.cos(w * t)),
                      w * t])
    np.testing.assert_allclose(traj[-1].numpy(), exact, rtol=0, atol=1e-10)


def test_rk4_solve_and_step_match_tpunav_f64():
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(16, 3))
    us = rng.normal(size=(20, 16, 2)) * 2.0
    f = lambda x, u: kinematic_cart(MODEL, x, u)
    jf = lambda x, u: j_cart(J_MODEL, x, u)
    got = rk4_solve(f, _t(x0), _t(us), 0.01).numpy()
    want = np.asarray(j_rk4_solve(jf, jnp.asarray(x0), jnp.asarray(us), 0.01))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    step = rk4_step(f, _t(x0), _t(us[0]), 1.0 / 60.0).numpy()
    jstep = np.asarray(j_rk4_step(jf, jnp.asarray(x0), jnp.asarray(us[0]),
                                  1.0 / 60.0))
    np.testing.assert_allclose(step, jstep, rtol=0, atol=1e-12)


def test_rk4_autonomous_matches_step_loop_f64():
    f = lambda x: kinematic_cart(MODEL, x, torch.tensor(
        [1.5, 2.5], dtype=torch.float64))
    traj = rk4_solve_autonomous(f, torch.zeros(3, dtype=torch.float64), 12,
                                0.05)
    x = torch.zeros(3, dtype=torch.float64)
    for _ in range(12):
        x = rk4_step(lambda s, _u: f(s), x, None, 0.05)
    assert traj.shape == (12, 3)
    np.testing.assert_allclose(traj[-1].numpy(), x.numpy(), rtol=0, atol=0)


# ------------------------------------------------------------ solver ----

def _noise(k, n, seed):
    return np.random.default_rng(seed).normal(scale=np.sqrt(0.9),
                                              size=(k, n, 2))


def _jax_solve(cfg, u, noise, pose, xd):
    loss, _ = jm.rollout_losses(cfg, J_MODEL, pose, u[None] + noise, xd)
    u_new = jm.update_controls(cfg, u, noise, jm.cost_to_go(loss))
    return u_new[0], jm.shift_controls(cfg, u_new)


@pytest.mark.parametrize("k,n,u_off", [(64, 50, 0.0), (128, 25, 0.7)])
def test_solve_matches_tpunav_f64(k, n, u_off):
    jcfg, cfg = jm.MPPIConfig(**_cfg(k, n)), tm.MPPIConfig(**_cfg(k, n))
    u = np.zeros((n, 2)) + [u_off, -0.5 * u_off]
    noise = _noise(k, n, seed=k)
    cmd_j, un_j = _jax_solve(jcfg, jnp.asarray(u), jnp.asarray(noise),
                             jnp.asarray(POSE), jnp.asarray(XD))
    cmd, un = tm.mppi_solve(cfg, MODEL, _t(u), None, _t(POSE), _t(XD),
                            noise=_t(noise))
    np.testing.assert_allclose(cmd.numpy(), np.asarray(cmd_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(un.numpy(), np.asarray(un_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("k,n", [(64, 50), (256, 25)])
def test_solve_matches_tpunav_f32(k, n):
    jcfg, cfg = jm.MPPIConfig(**_cfg(k, n)), tm.MPPIConfig(**_cfg(k, n))
    u = (np.zeros((n, 2)) + [0.4, 0.1]).astype(np.float32)
    noise = _noise(k, n, seed=3).astype(np.float32)
    f32 = jnp.float32
    cmd_j, un_j = _jax_solve(jcfg, jnp.asarray(u, f32),
                             jnp.asarray(noise, f32), jnp.asarray(POSE, f32),
                             jnp.asarray(XD, f32))
    t32 = torch.float32
    cmd, un = tm.mppi_solve(cfg, MODEL, _t(u, t32), None, _t(POSE, t32),
                            _t(XD, t32), noise=_t(noise, t32))
    assert un.dtype == torch.float32
    np.testing.assert_allclose(cmd.numpy(), np.asarray(cmd_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(un.numpy(), np.asarray(un_j), rtol=1e-4,
                               atol=1e-5)


def test_solve_matches_native_oracle_f64():
    """K=5, N=100 is the reference's own operating point
    (configs/mppi_params.yaml); the C++ solve is the oracle."""
    k, n = 5, 100
    cfg = tm.MPPIConfig(**_cfg(k, n))
    ref = native.MPPIRefParams(
        wheel_radius=0.033, wheel_base=0.160, lambda_=cfg.lambda_,
        max_wheel_vel=cfg.max_wheel_vel, dt=cfg.dt, steps=n, rollouts=k,
        q_diag=cfg.q_diag, r_diag=cfg.r_diag, p1_diag=cfg.p1_diag,
        u_init=cfg.u_init)
    u = np.zeros((n, 2))
    noise = np.random.default_rng(7).normal(scale=0.9, size=(k, n, 2))
    cmd_c, u_c = native.mppi_solve_ref(ref, u, noise, POSE, XD)
    cmd, un = tm.mppi_solve(cfg, MODEL, _t(u), None, _t(POSE), _t(XD),
                            noise=_t(noise))
    np.testing.assert_allclose(cmd_c, cmd.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(u_c, un.numpy(), rtol=1e-9, atol=1e-9)


def test_rollout_losses_terminal_row_and_extra_cost_f64():
    k, n = 8, 10
    jcfg, cfg = jm.MPPIConfig(**_cfg(k, n)), tm.MPPIConfig(**_cfg(k, n))
    up = _noise(k, n, seed=9)
    extra = lambda xy: (xy * xy).sum(-1)
    jl, jtraj = jm.rollout_losses(jcfg, J_MODEL, jnp.asarray(POSE),
                                  jnp.asarray(up), jnp.asarray(XD),
                                  extra_cost=lambda xy: jnp.sum(xy * xy, -1))
    tl, traj = tm.rollout_losses(cfg, MODEL, _t(POSE), _t(up), _t(XD),
                                 extra_cost=extra)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-12,
                               atol=1e-9)


def test_cost_to_go_reverse_cumsum():
    loss = torch.arange(12.0, dtype=torch.float64).reshape(4, 3)
    expected = np.flipud(np.cumsum(np.flipud(loss.numpy()), axis=0))
    np.testing.assert_allclose(tm.cost_to_go(loss).numpy(), expected)
    np.testing.assert_allclose(
        tm.cost_to_go(loss).numpy(),
        np.asarray(jm.cost_to_go(jnp.asarray(loss.numpy()))))


def test_controls_clamped():
    cfg = tm.MPPIConfig(ul_var=100.0, ur_var=100.0)
    u = tm.init_controls(cfg, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cmd, u_next = tm.mppi_solve(cfg, MODEL, u, gen,
                                torch.zeros(3, dtype=torch.float64),
                                torch.tensor([5.0, 5.0, 0.0],
                                             dtype=torch.float64))
    assert torch.all(u_next.abs() <= cfg.max_wheel_vel + 1e-12)
    assert torch.all(cmd.abs() <= cfg.max_wheel_vel + 1e-12)


def test_shift_refills_with_u_init():
    cfg = tm.MPPIConfig(u_init=(0.7, -0.3))
    u = torch.arange(2.0 * cfg.steps).reshape(cfg.steps, 2)
    shifted = tm.shift_controls(cfg, u)
    np.testing.assert_allclose(shifted[:-1].numpy(), u[1:].numpy())
    np.testing.assert_allclose(shifted[-1].numpy(), [0.7, -0.3])
    jshift = jm.shift_controls(jm.MPPIConfig(u_init=(0.7, -0.3)),
                               jnp.asarray(u.numpy()))
    np.testing.assert_allclose(shifted.numpy(), np.asarray(jshift))


def test_sample_perturbations_scale_and_generator():
    cfg = tm.MPPIConfig(rollouts=2000, horizon=0.1, ul_var=0.25, ur_var=4.0)
    a = tm.sample_perturbations(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    b = tm.sample_perturbations(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    assert a.shape == (2000, 10, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    std = a.reshape(-1, 2).std(0).numpy()
    np.testing.assert_allclose(std, [0.5, 2.0], rtol=0.05)


def test_controller_reaches_waypoint():
    # The solver drives the cart from the origin to a 0.5 m goal within a
    # simulated 10 s at 60 Hz.
    cfg = tm.MPPIConfig(horizon=0.5, rollouts=64)
    ctl = tm.MPPIController(cfg, MODEL, seed=7, dtype=torch.float64,
                            device="cpu")
    ctl.set_waypoint([0.5, 0.5, 0.0])
    pose = torch.zeros(3, dtype=torch.float64)
    f = lambda x, uu: kinematic_cart(MODEL, x, uu)
    for _ in range(600):
        cmd = ctl.new_controls(pose)
        pose = rk4_step(f, pose, cmd, 1.0 / 60.0)
        if float(torch.linalg.norm(pose[:2] - ctl.xd[:2])) < 0.1:
            break
    else:
        pytest.fail(f"never reached goal; final pose {pose.numpy()}")


def test_set_initial_controls():
    cfg = tm.MPPIConfig(horizon=0.1)
    ctl = tm.MPPIController(cfg, MODEL, device="cpu")
    ctl.set_initial_controls(1.0, -2.0)
    assert ctl.u.shape == (10, 2)
    np.testing.assert_allclose(ctl.u.numpy(), np.tile([1.0, -2.0], (10, 1)))


def _poses(steps, dtype):
    rng = np.random.default_rng(4)
    return [torch.as_tensor(POSE + 0.05 * i + 0.01 * rng.normal(size=3),
                            dtype=dtype) for i in range(steps)]


def test_controller_graph_equals_eager_solve():
    """Six solves through the controller's graph step, its perturbations
    drawn from its generator before each replay, with a waypoint and the
    initial controls set in between: the eager ``mppi_solve`` chain's
    commands and controls bit for bit, and the generator's state."""
    cfg = tm.MPPIConfig(horizon=0.2, rollouts=64)
    ctl = tm.MPPIController(cfg, MODEL, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    u = tm.init_controls(cfg, device="cpu")
    xd = torch.zeros(3)
    for i, pose in enumerate(_poses(6, torch.float32)):
        if i == 2:
            ctl.set_waypoint(XD)
            xd = torch.as_tensor(XD, dtype=torch.float32)
        if i == 4:
            ctl.set_initial_controls(0.5, -0.25)
            u = torch.tensor([0.5, -0.25]).expand_as(u).clone()
        cmd = ctl.new_controls(pose.numpy())
        want, u = tm.mppi_solve(cfg, MODEL, u, gen, pose, xd)
        assert torch.equal(cmd, want) and torch.equal(ctl.u, u), i
    assert torch.equal(ctl.xd, xd)
    assert torch.equal(ctl.generator.get_state(), gen.get_state())


def test_controller_with_injected_noise_matches_tpunav():
    """Five solves in float64 with ``tpunav``'s perturbations (its key's
    splits) injected through ``noise=``: ``tpunav``'s MPPIController's
    commands and controls within 1e-9."""
    import jax

    cfg_kw = _cfg(64, 30)
    jcfg, cfg = jm.MPPIConfig(**cfg_kw), tm.MPPIConfig(**cfg_kw)
    theirs = jm.MPPIController(jcfg, J_MODEL, seed=2, dtype=jnp.float64)
    ours = tm.MPPIController(cfg, MODEL, seed=0, dtype=torch.float64,
                             device="cpu")
    theirs.set_waypoint(XD)
    ours.set_waypoint(XD)
    key = jax.random.PRNGKey(2)
    for pose in _poses(5, torch.float64):
        key, sub = jax.random.split(key)
        noise = jm.sample_perturbations(jcfg, sub, dtype=jnp.float64)
        want = theirs.new_controls(jnp.asarray(pose.numpy()))
        got = ours.new_controls(pose, noise=_t(np.array(noise)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ours.u.numpy(), np.asarray(theirs.u),
                                   rtol=0, atol=1e-9)


# ------------------------------------------------------------ guards ----

def test_port_imports_no_jax():
    """Every module of the package, and every demo of the port, import
    without jax, tpunav, or tpunav's demos and results script."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpunav_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpunav_torch.__path__, 'tpunav_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import examples_torch\n"
        "demos = [m.name for m in pkgutil.iter_modules(\n"
        "    examples_torch.__path__, 'examples_torch.')]\n"
        "for name in demos:\n"
        "    importlib.import_module(name)\n"
        "want = {'examples_torch.' + d for d in (\n"
        "    'rbpf_explore_demo', 'full_stack_demo', 'lidar_ekf_slam_demo',\n"
        "    'dense_world_slam_demo', 'slam_mppi_closed_loop_demo',\n"
        "    'mppi_waypoints_demo', 'obstacle_mppi_demo', 'ekf_slam_demo',\n"
        "    'rbpf_slam_demo', 'planners_demo', 'rigid2d_frames_demo',\n"
        "    'live_view_demo', 'full_stack_two_process',\n"
        "    'profile_rbpf_stages', 'make_results', 'mppi_two_process',\n"
        "    'rbpf_two_process')}\n"
        "assert want <= set(demos), want - set(demos)\n"
        "importlib.import_module('chip_smoke')\n"
        "need = {'tpunav_torch.interop', 'tpunav_torch.ops.fused_mppi',\n"
        "        'tpunav_torch.capture',\n"
        "        'tpunav_torch.ops.likelihood', 'tpunav_torch.ops.map_update',\n"
        "        'tpunav_torch.estimation.rbpf.particle_filter',\n"
        "        'tpunav_torch.estimation.rbpf.icp', 'tpunav_torch.core.se2',\n"
        "        'tpunav_torch.sim.lidar', 'tpunav_torch.ops.beams',\n"
        "        'tpunav_torch.control.obstacle_cost',\n"
        "        'tpunav_torch.planning.prm', 'tpunav_torch.planning.dstar',\n"
        "        'tpunav_torch.core.diff_drive', 'tpunav_torch.core.waypoints',\n"
        "        'tpunav_torch.core.randoms',\n"
        "        'tpunav_torch.estimation.ekf.filter',\n"
        "        'tpunav_torch.estimation.ekf.spd',\n"
        "        'tpunav_torch.estimation.landmarks',\n"
        "        'tpunav_torch.sim.landmark_sensor',\n"
        "        'tpunav_torch.control.slam_loop',\n"
        "        'tpunav_torch.runtime.config',\n"
        "        'tpunav_torch.runtime.distributed',\n"
        "        'tpunav_torch.parallel', 'tpunav_torch.parallel.mesh',\n"
        "        'tpunav_torch.parallel.mppi_sharded',\n"
        "        'tpunav_torch.parallel.rbpf_sharded'}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpunav',\n"
        "                                    'examples', 'make_results'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from tpunav_torch.ops import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None


def test_mppi_params_yaml_loads_equal_in_both_packages():
    from tpunav.runtime.config import load_mppi_config as j_load
    from tpunav.runtime.config import load_robot_config as j_robot
    from tpunav_torch.runtime.config import (load_mppi_config,
                                             load_robot_config,
                                             load_waypoints)

    path = os.path.join(REPO, "configs", "mppi_params.yaml")
    got = load_mppi_config(path, horizon=0.5, rollouts=4096)
    want = j_load(path, horizon=0.5, rollouts=4096)
    assert isinstance(got, tm.MPPIConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.steps == want.steps == 50
    robot = os.path.join(REPO, "configs", "diff_params.yaml")
    assert dataclasses.asdict(load_robot_config(robot)) == \
        dataclasses.asdict(j_robot(robot))
    wpts = load_waypoints(os.path.join(REPO, "configs", "real_waypoints.yaml"))
    assert wpts.shape == (5, 3)


def test_config_fields_and_defaults_match_tpunav():
    from tpunav.control.waypoint_loop import CourseConfig as JCourse
    from tpunav.sim.motor import MotorParams as JMotor
    from tpunav_torch.control.waypoint_loop import CourseConfig
    from tpunav_torch.sim.motor import MotorParams

    for ours, theirs in [(tm.MPPIConfig, jm.MPPIConfig),
                         (CourseConfig, JCourse), (MotorParams, JMotor)]:
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    assert CartParams._fields == JCartParams._fields
