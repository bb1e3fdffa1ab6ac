"""The port's core modules against ``tpunav`` and the reference's goldens.

``core/diff_drive.py`` on the gtest goldens of tests/test_diff_drive.py and
against ``tpunav`` on random inputs; ``core/waypoints.py`` step for step
against ``tpunav``; ``core/randoms.py`` by distribution (a
``torch.Generator`` cannot replay a ``jax.random`` key); the already-ported
``angles`` and ``se2`` on the goldens of tests/test_angles.py and
tests/test_se2.py; and the four config loaders the port lacked
(``RobotConfig.diff_drive``, ``save_yaml_config``, ``load_landmarks``,
``load_world``) against ``tpunav``'s on ``configs/*.yaml``.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.core import diff_drive as jdd
from tpunav.core import waypoints as jwp
from tpunav.runtime import config as jconfig
from tpunav_torch.core import angles, randoms, se2
from tpunav_torch.core import diff_drive as dd
from tpunav_torch.core import waypoints as wp
from tpunav_torch.runtime import config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PI = math.pi
# The reference's test geometry (test_diff_drive.cpp): base 1.0, radius 0.02.
PARAMS = dd.DiffDriveParams(wheel_radius=0.02, wheel_base=1.0)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _state(theta=0.0, x=0.0, y=0.0):
    return dd.init_state(theta, x, y, dtype=torch.float64, device="cpu")


# ------------------------------------------- tests/test_diff_drive.py ----

@pytest.mark.parametrize("twist,wheels", [
    ([0.0, 0.01, 0.0], [0.5, 0.5]),                  # ref :14-45
    ([PI / 10, 0.0, 0.0], [-(PI / 10) * 0.5 / 0.02, (PI / 10) * 0.5 / 0.02]),
])
def test_twist_to_wheels_goldens(twist, wheels):
    got = dd.twist_to_wheels(PARAMS, _t(twist))
    np.testing.assert_allclose(got.numpy(), wheels, atol=1e-12)
    back = dd.wheels_to_twist(PARAMS, got)
    np.testing.assert_allclose(back.numpy(), twist, atol=1e-12)


@pytest.mark.parametrize("left,right,vel,pose", [
    (PI / 30, PI / 30, [0.10472, 0.10472], [0.0, 0.0020944, 0.0]),
    (0.0, 0.0, [0.0, 0.0], [0.0, 0.0, 0.0]),
    (-PI / 30, PI / 30, [-0.10472, 0.10472], [0.00418879, 0.0, 0.0]),
    (0.0, PI / 30, [0.0, 0.10472], [0.0020944, 0.0010472, 0.0]),
])
def test_update_odometry_goldens(left, right, vel, pose):
    """rigid2d/test/test_diff_drive.cpp:120-276."""
    st, v = dd.update_odometry(PARAMS, _state(), left, right)
    np.testing.assert_allclose(v.numpy(), vel, atol=1e-3)
    np.testing.assert_allclose(dd.pose(st).numpy(), pose, atol=1e-3)


@pytest.mark.parametrize("cmd,pose", [
    ([0.0, 0.01, 0.0], [0.0, 0.01, 0.0]),
    ([PI / 10, 0.0, 0.0], [0.314159, 0.0, 0.0]),
    ([PI / 10, 0.01, 0.0], [0.314159, 0.00983632, 0.00155792]),
])
def test_feedforward_goldens(cmd, pose):
    """rigid2d/test/test_diff_drive.cpp:281-388."""
    st = dd.feedforward(PARAMS, _state(), _t(cmd))
    np.testing.assert_allclose(dd.pose(st).numpy(), pose, atol=1e-3)


@pytest.mark.parametrize("cmd", [[0.0, 0.01, 0.0], [0.05, 0.01, 0.0]])
def test_feedforward_update_odometry_consistency(cmd):
    """Feedforward on one model equals updateOdometry fed its encoders on a
    second (rigid2d/test/test_diff_drive.cpp:391-475)."""
    st1 = dd.feedforward(PARAMS, _state(), _t(cmd))
    st2, _ = dd.update_odometry(PARAMS, _state(), st1.left, st1.right)
    np.testing.assert_allclose(dd.pose(st1).numpy(), dd.pose(st2).numpy(),
                               atol=1e-3)
    for name in ("left", "right", "ul", "ur"):
        assert abs(float(getattr(st1, name)) - float(getattr(st2, name))) \
            < 1e-3


def test_batched_over_robots_and_reset():
    """A fleet axis in front of every leaf (tests/test_diff_drive.py:134),
    and reset keeps the encoders."""
    n = 16
    lefts = torch.linspace(-0.3, 0.3, n, dtype=torch.float64)
    rights = torch.linspace(0.2, -0.1, n, dtype=torch.float64)
    fleet = dd.DiffDriveState(*(leaf.expand(n, *leaf.shape)
                                for leaf in _state()))
    sts, vels = dd.update_odometry(PARAMS, fleet, lefts, rights)
    st5, vel5 = dd.update_odometry(PARAMS, _state(), lefts[5], rights[5])
    np.testing.assert_allclose(vels[5].numpy(), vel5.numpy(), atol=1e-12)
    np.testing.assert_allclose(sts.pose[5].numpy(), st5.pose.numpy(),
                               atol=1e-12)
    st, _ = dd.update_odometry(PARAMS, _state(), 0.5, 0.7)
    st2 = dd.reset(st, 0.0, 0.0, 0.0)
    np.testing.assert_array_equal(st2.pose.numpy(), [0.0, 0.0, 0.0])
    assert float(st2.left) == float(st.left)
    assert float(st2.right) == float(st.right)


def test_diff_drive_chains_match_tpunav():
    """50 odometry updates and 30 feedforward steps, float64, against
    ``tpunav`` at 1e-12; the TURTLEBOT3 constants equal."""
    assert tuple(dd.TURTLEBOT3) == tuple(jdd.TURTLEBOT3)
    assert (dd.MAX_TRANS_VEL, dd.MAX_ROT_VEL, dd.MAX_WHEEL_VEL,
            dd.MAX_MOTOR_POWER, dd.ENCODER_TICKS_PER_REV) == (
        jdd.MAX_TRANS_VEL, jdd.MAX_ROT_VEL, jdd.MAX_WHEEL_VEL,
        jdd.MAX_MOTOR_POWER, jdd.ENCODER_TICKS_PER_REV)
    rng = np.random.default_rng(7)
    jst = jdd.init_state(0.2, 0.1, -0.3, dtype=jnp.float64)
    st = dd.init_state(0.2, 0.1, -0.3, dtype=torch.float64, device="cpu")
    for left, right in np.cumsum(rng.normal(scale=0.3, size=(50, 2)), 0):
        jst, jv = jdd.update_odometry(jdd.TURTLEBOT3, jst, left, right)
        st, v = dd.update_odometry(dd.TURTLEBOT3, st, left, right)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-12)
    for cmd in rng.normal(scale=[0.5, 0.1, 0.0], size=(30, 3)):
        jst = jdd.feedforward(jdd.TURTLEBOT3, jst, jnp.asarray(cmd))
        st = dd.feedforward(dd.TURTLEBOT3, st, _t(cmd))
    for name in jdd.DiffDriveState._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(dd.pose(st).numpy(), np.asarray(jdd.pose(jst)),
                               atol=1e-12)


# ------------------------------------------------------------ waypoints --

@pytest.mark.parametrize("closed_loop", [False, True])
def test_waypoint_controllers_match_tpunav(closed_loop):
    """A unicycle driven by each controller for 400 steps: commands and
    bookkeeping equal ``tpunav``'s on every step (float64)."""
    pts = [[0.3, 0.0], [0.3, 0.3], [0.0, 0.3]]
    kw = dict(rot_vel=0.5, trans_vel=0.05, k_rot=2.0, htol=0.05, ptol=0.03)
    jp = jwp.make_params(jnp.asarray(pts), dtype=jnp.float64, **kw)
    tp = wp.make_params(pts, dtype=torch.float64, device="cpu", **kw)
    jstep = jwp.next_waypoint_closed_loop if closed_loop else \
        jwp.next_waypoint
    tstep = wp.next_waypoint_closed_loop if closed_loop else wp.next_waypoint
    js, ts = jwp.init_state(), wp.init_state(device="cpu")
    pose = np.zeros(3)
    visited = 0
    for _ in range(400):
        jc, js = jstep(jp, js, jnp.asarray(pose))
        tc, ts = tstep(tp, ts, _t(pose))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-12)
        assert int(ts.idx) == int(js.idx) and int(ts.ctr) == int(js.ctr)
        assert bool(ts.cycle_complete) == bool(js.cycle_complete)
        w, vx = np.asarray(jc)[:2] * 0.1
        pose = pose + [w, vx * math.cos(pose[0] + w), vx * math.sin(
            pose[0] + w)]
        visited = max(visited, int(ts.ctr))
    assert visited >= 2                      # the controller made progress


# -------------------------------------------------------------- randoms --

N_DRAWS = 20_000


def _moments_ok(x, mean, std):
    """Sample mean and std within 4σ of their sampling error."""
    x = x.double()
    n = x.numel()
    assert abs(float(x.mean()) - mean) < 4 * std / math.sqrt(n)
    assert abs(float(x.std()) - std) < 4 * std / math.sqrt(2 * n)


def test_randoms_distributions():
    gen = torch.Generator().manual_seed(0)
    _moments_ok(randoms.sample_normal(gen, 1.5, 0.3, (N_DRAWS,)), 1.5, 0.3)
    u = randoms.sample_uniform(gen, -2.0, 3.0, (N_DRAWS,))
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    _moments_ok(u, 0.5, 5.0 / math.sqrt(12.0))
    cov = torch.tensor([[0.04, 0.018], [0.018, 0.09]], dtype=torch.float64)
    x = randoms.sample_multivariate(gen, cov, (N_DRAWS,))
    assert x.shape == (N_DRAWS, 2)
    emp = torch.cov(x.T)
    # Each entry's sampling error is below sqrt((σii·σjj + σij²)/n).
    err = torch.sqrt((torch.outer(cov.diag(), cov.diag()) + cov ** 2)
                     / N_DRAWS)
    assert bool(((emp - cov).abs() < 4 * err).all()), emp
    _moments_ok(x[:, 0], 0.0, 0.2)
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert bool(torch.isnan(randoms.sample_multivariate(gen, bad, (3,)))
                .all())
    assert float(randoms.euclidean_distance(0.0, 0.0, 3.0, 4.0)) == 5.0


# ------------------------------------- tests/test_angles.py, test_se2.py --

def test_angles_goldens():
    """rigid2d/include/rigid2d/rigid2d.hpp:111-138, as tests/test_angles.py
    holds ``tpunav``."""
    f = angles.normalize_angle_pi
    assert math.isclose(angles.deg2rad(45.0), PI / 4)
    assert math.isclose(angles.rad2deg(PI / 6), 30.0)
    for rad, want in [(1.5 * PI, -PI / 2), (7 / 6 * PI, -5 / 6 * PI),
                      (8 / 3 * PI, 2 / 3 * PI), (PI, -PI), (-PI, -PI)]:
        assert math.isclose(float(f(_t(rad))), want, abs_tol=1e-12)
    assert math.isclose(float(f(_t(angles.deg2rad(350)))),
                        float(f(_t(angles.deg2rad(-10)))))
    out = f(torch.linspace(-20.0, 20.0, 1001, dtype=torch.float64))
    assert bool((out >= -PI - 1e-12).all() and (out < PI + 1e-12).all())
    g = angles.normalize_angle_2pi
    for rad, want in [(2 * PI + PI / 6, PI / 6), (PI / 6, PI / 6),
                      (0.5, 0.5), (-PI / 4, 7 * PI / 4)]:
        assert math.isclose(float(g(_t(rad))), want, abs_tol=1e-12)


T90 = (PI / 2, -1.0, 3.0)


def test_se2_goldens():
    """rigid2d/test/test_rigid2d.cpp (apply, inverse, compose at 90°; the
    IntegrateTwist cases at :260-335), as tests/test_se2.py holds
    ``tpunav``."""
    T = se2.make(*(_t(v) for v in T90))
    np.testing.assert_allclose(se2.apply(T, _t([1.0, 0.0])).numpy(),
                               [-1.0, 4.0], atol=1e-12)
    p = _t([0.3, -2.0])
    np.testing.assert_allclose(
        se2.apply(se2.inverse(T), se2.apply(T, p)).numpy(), p.numpy(),
        atol=1e-12)
    np.testing.assert_allclose(se2.compose(T, se2.inverse(T)).numpy(),
                               [0.0, 0.0, 0.0], atol=1e-12)
    V = _t([0.7, 1.1, -0.4])
    R = np.array([[0.0, -1.0], [1.0, 0.0]])
    want_v = R @ [1.1, -0.4] + 0.7 * np.array([3.0, 1.0])
    np.testing.assert_allclose(se2.adjoint(T, V).numpy(), [0.7, *want_v],
                               atol=1e-12)
    for twist, want in [([0.0, 1.0, 1.0], (90.0, -2.0, 4.0)),
                        ([1.0, 1.0, 1.0], (147.296, -2.30117, 3.38177))]:
        th, x, y = se2.integrate_twist(T, _t(twist)).numpy()
        np.testing.assert_allclose([math.degrees(th), x, y], want,
                                   atol=1e-3)
    np.testing.assert_allclose(se2.integrate_twist(T, _t([0.0] * 3)).numpy(),
                               T.numpy(), atol=1e-12)
    Vs = _t([[0.5, 1.0, -0.3], [0.0, 0.2, 0.1], [1e-8, -0.5, 0.4],
             [3.0, 0.0, 2.0]])
    np.testing.assert_allclose(se2.log_twist(se2.exp_twist(Vs)).numpy(),
                               Vs.numpy(), atol=1e-9)


# -------------------------------------------------------------- configs --

def test_config_loaders_match_tpunav(tmp_path):
    """The four loaders the port's copy lacked, on configs/*.yaml."""
    robot_yaml = os.path.join(REPO, "configs", "diff_params.yaml")
    robot = config.load_robot_config(robot_yaml)
    jrobot = jconfig.load_robot_config(robot_yaml)
    assert tuple(robot.diff_drive) == tuple(jrobot.diff_drive)
    assert isinstance(robot.diff_drive, dd.DiffDriveParams)

    path = os.path.join(REPO, "configs", "block_world_landmarks.yaml")
    (centers, ids), (jcenters, jids) = (config.load_landmarks(path),
                                        jconfig.load_landmarks(path))
    assert centers.shape == (12, 2) and centers.dtype == np.float64
    np.testing.assert_array_equal(centers, jcenters)
    np.testing.assert_array_equal(ids, jids)

    path = os.path.join(REPO, "configs", "map_boundaries.yaml")
    for scale in (1.0, 0.1):
        got, want = config.load_world(path, scale), jconfig.load_world(
            path, scale)
        for name in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)))

    out = tmp_path / "robot.yaml"
    config.save_yaml_config(robot, str(out))
    jconfig.save_yaml_config(jrobot, str(tmp_path / "j.yaml"))
    assert out.read_text() == (tmp_path / "j.yaml").read_text()
    assert config.load_robot_config(str(out)) == robot


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device: the default is usable")
    for fn in (dd.init_state, wp.init_state,
               lambda: wp.make_params([[0.0, 0.0]], 1.0, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
