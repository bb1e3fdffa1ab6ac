"""The port's EKF demos (``examples_torch.lidar_ekf_slam_demo``,
``dense_world_slam_demo``, ``slam_mppi_closed_loop_demo``,
``ekf_slam_demo``) against ``tpunav``'s (``examples/``).

- The lidar → detector → EKF course: 40 steps, known and unknown DA, in
  float32, with ``tpunav``'s scan noise (its key splits replayed) handed
  to the port; ``tpunav``'s ``make_sim`` runs with x64 off, as it runs on
  its device (its scan carry is float32). Pose within 1e-5, landmarks
  within 1e-4, the same tracked count: the float32 bars of ROADMAP.md §3.
- The dense world: the world and the waypoint ring equal ``tpunav``'s,
  and 200 ticks at K=64 finish with finite outputs. Whole courses are
  judged by outcome only: two float32 filters drift apart (ROADMAP.md §3).
- Shortened runs of config 3/4's closed loop and of the EKF demo.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import dense_world_slam_demo as jdw
from examples import lidar_ekf_slam_demo as jle
from examples_torch import dense_world_slam_demo as tdw
from examples_torch import ekf_slam_demo as tek
from examples_torch import lidar_ekf_slam_demo as tle
from examples_torch import slam_mppi_closed_loop_demo as tcl
from tpunav.estimation.ekf import EKFConfig as JEKFConfig
from tpunav.estimation.ekf import known_correspondence_slam as j_known
from tpunav.estimation.ekf import slam_unknown_da as j_unknown
from tpunav_torch.estimation.ekf import filter as ekff

torch.set_num_threads(2)

STEPS = 40


def _tpunav_course(tag):
    """tpunav's lidar EKF course of STEPS steps (seed 0, x64 off) and its
    scan normals (make_sim's key splits,
    examples/lidar_ekf_slam_demo.py:57-64)."""
    step, known, cfg = tle.CONFIGS[tag]
    jcfg = JEKFConfig(**dataclasses.asdict(cfg))
    with jax.enable_x64(False):
        sim = jle.make_sim(j_known if known else j_unknown, jcfg, known,
                           STEPS)
        true_pose, _, jst, _ = sim(jax.random.PRNGKey(0))
        key, normals = jax.random.PRNGKey(0), []
        for _ in range(STEPS):
            key, k1 = jax.random.split(key)
            normals.append(np.asarray(jax.random.normal(k1, (360,),
                                                        jnp.float32)))
    return true_pose, jst, torch.from_numpy(np.stack(normals))


def _assert_course_near(got_pose, st, true_pose, jst):
    """The float32 bars of ROADMAP.md §3: pose within 1e-5, landmarks
    within 1e-4, the same landmarks and count."""
    np.testing.assert_allclose(got_pose.numpy(), np.asarray(true_pose),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.state[:3].numpy(),
                               np.asarray(jst.state[:3]), rtol=0, atol=1e-5)
    active = np.asarray(jst.active)
    np.testing.assert_array_equal(st.active.numpy(), active)
    lms = st.state[3:].reshape(-1, 2).numpy()[active]
    np.testing.assert_allclose(
        lms, np.asarray(jst.state[3:]).reshape(-1, 2)[active], rtol=0,
        atol=1e-4)
    assert int(st.count) == int(jst.count) >= 10


@pytest.mark.parametrize("tag", ["known", "unknown"])
def test_lidar_ekf_course_matches_tpunav(tag):
    step, known, cfg = tle.CONFIGS[tag]
    true_pose, jst, normals = _tpunav_course(tag)
    got_pose, _, st, tel = tle.make_sim(step, cfg, known, STEPS, "cpu")(
        0, noise=normals)
    _assert_course_near(got_pose, st, true_pose, jst)
    assert tel.shape == (STEPS, 5) and torch.isfinite(tel).all()


@pytest.mark.parametrize("tag", ["known", "unknown"])
def test_lidar_ekf_eager_course_matches_tpunav(tag):
    """The eager course (the dynamic update, row count read on the host)
    with tpunav's normals, at the bars of the graphed course's test."""
    step, known, cfg = tle.CONFIGS[tag]
    true_pose, jst, normals = _tpunav_course(tag)
    got_pose, _, st, tel = tle.make_sim(step, cfg, known, STEPS, "cpu",
                                        eager=True)(0, noise=normals)
    _assert_course_near(got_pose, st, true_pose, jst)
    assert tel.shape == (STEPS, 5) and torch.isfinite(tel).all()


_MASKED = {True: ekff.known_correspondence_slam_masked,
           False: ekff.slam_unknown_da_masked}


def _assert_same_bits(got, want):
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            _assert_same_bits(a, b)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("tag", ["known", "unknown"])
def test_lidar_ekf_graph_equals_eager_masked(tag):
    """STEPS steps through ``StepGraph`` (``make_sim``'s default): the
    masked update run eagerly on the same inputs gives every output bit
    for bit (poses, state, telemetry); the dynamic form matches at the
    float32 bars. A second seed through the same graph equals a fresh
    graph's run."""
    step, known, cfg = tle.CONFIGS[tag]
    sim = tle.make_sim(step, cfg, known, STEPS, "cpu")
    got = sim(0)
    masked = tle.make_sim(_MASKED[known], cfg, known, STEPS, "cpu",
                          eager=True)(0)
    _assert_same_bits(got, masked)
    dyn_pose, _, dyn, _ = tle.make_sim(step, cfg, known, STEPS, "cpu",
                                       eager=True)(0)
    _assert_course_near(got[0], got[2], dyn_pose.numpy(),
                        ekff.EKFState(*(t.numpy() for t in dyn)))
    again = sim(1)
    _assert_same_bits(again, tle.make_sim(step, cfg, known, STEPS,
                                          "cpu")(1))
    _assert_same_bits(sim(0), got)


@pytest.mark.parametrize("name", sorted(tek.CONFIGS))
def test_ekf_demo_graph_equals_eager_masked(name):
    """60 steps of the EKF demo's arc through ``StepGraph`` against the
    masked update run eagerly, bit for bit, and the dynamic form at the
    float32 bars."""
    step, cfg = tek.CONFIGS[name]
    got = tek.make_course(step, cfg, 60, "cpu")(0)
    masked = tek.make_course(_MASKED[tle.known_da(step)], cfg, 60, "cpu",
                             eager=True)(0)
    _assert_same_bits(got, masked)
    dyn_pose, _, dyn = tek.make_course(step, cfg, 60, "cpu", eager=True)(0)
    _assert_course_near(got[0], got[2], dyn_pose.numpy(),
                        ekff.EKFState(*(t.numpy() for t in dyn)))


def test_lidar_ekf_run_many_loops_over_seeds():
    step, known, cfg = tle.CONFIGS["known"]
    errs, odos, counts, wall = tle.run_many(step, cfg, known, [0, 1], 20,
                                            device="cpu")
    assert errs.shape == odos.shape == (2, 3) and counts.shape == (2,)
    assert not np.array_equal(errs[0], errs[1])      # the seed's scan noise
    np.testing.assert_array_equal(odos[0], odos[1])  # odometry has none
    one = tle.run(step, cfg, known, 20, seed=1, device="cpu")
    np.testing.assert_array_equal(one[0], errs[1])
    assert wall > 0


@pytest.mark.parametrize("name", ["dense_world", "waypoint_ring"])
def test_dense_world_geometry_matches_tpunav(name):
    want = np.asarray(getattr(jdw, name)().astype(jnp.float32))
    got = getattr(tdw, name)()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dense_world_course_completes_finite():
    """200 ticks of config 4 at K=64 through K1's plain version: finite
    filter, finite telemetry, landmarks found."""
    course = tdw.build(steps=200, rollouts=64, device="cpu")[0]
    out = course(0)
    st = out["state"]
    for t in (st.ekf.state, st.ekf.cov, st.true_pose, st.odom):
        assert torch.isfinite(t).all()
    assert out["tel"].shape == (200, 5) and np.isfinite(out["tel"]).all()
    assert np.isfinite(out["ekf_err"]).all() and out["count"] >= 3


@pytest.mark.parametrize("known", [True, False])
def test_slam_mppi_closed_loop_shortened(known):
    lms = tcl.block_world() if known else tcl.random_landmarks()
    out = tcl.run("test", lms, known, 12 if known else 60, rollouts=64,
                  max_ticks=120, verbose=False, device="cpu")
    assert out["ticks"] == 120
    assert np.isfinite([out["ekf_err_m"], out["odom_err_m"]]).all()
    assert torch.isfinite(out["state"].ekf.state).all()
    assert out["landmarks"] >= 1


def test_random_landmarks_in_the_box():
    lms = tcl.random_landmarks()
    assert lms.shape == (50, 2) and lms.dtype == np.float32
    assert (np.abs(lms) <= 0.9).all()
    np.testing.assert_array_equal(lms, tcl.random_landmarks())


@pytest.mark.parametrize("name", sorted(tek.CONFIGS))
def test_ekf_slam_demo_shortened(name):
    step, cfg = tek.CONFIGS[name]
    ekf_err, odo_err, n_lm, wall, steps = tek.run(step, cfg, steps=60,
                                                  device="cpu")
    assert steps == 60 and n_lm >= 3
    assert np.isfinite(ekf_err).all() and np.isfinite(odo_err).all()
    assert np.hypot(*ekf_err[1:]) < np.hypot(*odo_err[1:])
