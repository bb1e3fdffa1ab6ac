"""The port's EKF SLAM (``estimation/ekf/``), landmark sensor and their
interop against ``tpunav``.

- ``spd``: each function against ``tpunav``'s, including a failed factor
  (an indefinite matrix is not SPD) and a NaN matrix.
- The filter's pieces: the motion and uncertainty updates, the sparse-H
  algebra against the dense Jacobian, ``_maha_all`` (+inf for a non-finite
  or clearly negative d², the clamp at 0).
- float64 courses: the two 10-step courses of tests/test_native_parity.py
  against ``tpunav`` and the C oracle (``tpunav/native``) at 1e-9, with
  equal active masks and counts.
- float32 courses against ``tpunav``: pose atol 1e-5, landmarks 1e-4,
  covariance rtol 1e-3 + atol 1e-7·max|Σ|; gate decisions equal, or
  differing only where the float64 d* lies within 1e-4 relative of dmin or
  dmax (counted and bounded).
- The prediction alone (no measurement rows) equals the step on all-NaN
  rows, the slam loop's off-schedule tick, bit for bit and equal to
  ``tpunav``'s.
- The behaviours of tests/test_ekf.py, the sensor with injected noise,
  the noise draws by distribution, and the interop loaders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav import native
from tpunav.estimation.ekf import filter as jf
from tpunav.estimation.ekf import spd as jspd
from tpunav.sim import landmark_sensor as jsensor
from tpunav_torch import interop
from tpunav_torch.core.angles import normalize_angle_pi
from tpunav_torch.estimation.ekf import filter as tf
from tpunav_torch.estimation.ekf import spd
from tpunav_torch.ops import ekf_rows
from tpunav_torch.sim import landmark_sensor as sensor

torch.set_num_threads(1)

# 12 ground-truth cylinders (tests/test_ekf.py).
LANDMARKS = np.array([
    [0.75, 0.1], [0.95, 0.6], [0.5, 0.8], [0.1, 0.75],
    [-0.4, 0.9], [-0.8, 0.5], [-0.9, 0.0], [-0.7, -0.55],
    [-0.2, -0.8], [0.3, -0.9], [0.8, -0.6], [1.0, -0.1]])
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _cfgs(**kw):
    return jf.EKFConfig(**kw), tf.EKFConfig(**kw)


def _init(tcfg, dtype=torch.float64):
    return tf.ekf_init(tcfg, dtype=dtype, device="cpu")


def _jstep(jcfg, known):
    fn = jf.known_correspondence_slam if known else jf.slam_unknown_da
    return jax.jit(lambda st, m, u: fn(jcfg, st, m, u))


def _tstep(known):
    return tf.known_correspondence_slam if known else tf.slam_unknown_da


def _native_course(n_lm, seed, vis, u, steps=10):
    """tests/test_native_parity.py:209-294: robot-frame measurements of
    ``n_lm`` random landmarks along an arc, NaN beyond ``vis``, 1 mm
    noise."""
    rng = np.random.default_rng(seed)
    lms = rng.uniform(-1.0 if seed == 2 else -1.2, 1.0 if seed == 2
                      else 1.2, (n_lm, 2))
    pose, out = np.zeros(3), []
    for _ in range(steps):
        pose = np.array([pose[0] + u[0],
                         pose[1] + u[1] * np.cos(pose[0] + u[0]),
                         pose[2] + u[1] * np.sin(pose[0] + u[0])])
        ct, s_ = np.cos(pose[0]), np.sin(pose[0])
        rel = lms - pose[1:3]
        rf = np.stack([ct * rel[:, 0] + s_ * rel[:, 1],
                       -s_ * rel[:, 0] + ct * rel[:, 1]], -1)
        visible = np.linalg.norm(rel, axis=1) < vis
        out.append(np.where(visible[:, None],
                            rf + rng.normal(0, 1e-3, rf.shape), np.nan))
    return out


# The two courses of tests/test_native_parity.py.
KNOWN_KW = dict(num_landmarks=6, spd_repair=False,
                motion_noise=(1e-6, 1e-6, 1e-6),
                measurement_noise=(1e-5, 1e-5))
UNKNOWN_KW = dict(num_landmarks=8, dmin=5e1, dmax=1e4, spd_repair=False,
                  motion_noise=(1e-5, 1e-5, 1e-5),
                  measurement_noise=(1e-5, 1e-5))
COURSES = {True: (KNOWN_KW, lambda: _native_course(6, 2, 1.1, (0.03, 0.015)),
                  (0.03, 0.015)),
           False: (UNKNOWN_KW, lambda: _native_course(6, 5, 1.2,
                                                      (0.02, 0.012)),
                   (0.02, 0.012))}


# ------------------------------------------------------------------ spd --

def _spd_cases():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6))
    good = a @ a.T + 0.1 * np.eye(6)
    asym = good.copy()
    asym[0, 1] += 1.0
    semi = np.outer(a[0], a[0])                      # rank 1: factor fails
    return {"indefinite": np.array([[1.0, 2.0], [2.0, 1.0]]),
            "good": good, "benign_asymmetry": good + 1e-14 * a,
            "asymmetric": asym, "rank_one": semi,
            "nan": np.full((3, 3), np.nan),
            "negative_diag": -np.eye(3)}


@pytest.mark.parametrize("name", sorted(_spd_cases()))
def test_spd_functions_match_tpunav(name):
    m = _spd_cases()[name]
    want = bool(jspd.is_spd(jnp.asarray(m)))
    assert bool(spd.is_spd(_t(m))) == want
    if name == "indefinite":
        assert not want                    # tpunav reads the NaN factor
    if name == "nan":
        return
    fixed = spd.nearest_spd(_t(m))
    np.testing.assert_allclose(fixed.numpy(),
                               np.asarray(jspd.nearest_spd(jnp.asarray(m))),
                               rtol=1e-9, atol=1e-12)
    assert bool(spd.is_spd(fixed)) == bool(jspd.is_spd(
        jspd.nearest_spd(jnp.asarray(m))))
    np.testing.assert_allclose(
        spd.repair_if_needed(_t(m)).numpy(),
        np.asarray(jspd.repair_if_needed(jnp.asarray(m))), rtol=1e-9,
        atol=1e-12)


# --------------------------------------------------------- filter pieces --

def test_motion_and_uncertainty_updates_match_tpunav():
    """Arc, straight (|ω| < 1e-12) and ω = 0 exactly, with motion noise,
    float64 at 1e-12 (and the reference formulas of tests/test_ekf.py)."""
    jcfg, tcfg = _cfgs(num_landmarks=3)
    rng = np.random.default_rng(1)
    state = rng.normal(size=tcfg.state_size)
    a = rng.normal(size=(9, 9))
    cov = a @ a.T
    for u in ([0.5, 0.1], [1e-13, 0.1], [0.0, -0.2], [-0.3, 0.0]):
        w = rng.normal(scale=1e-3, size=3)
        got = tf.motion_update(tcfg, _t(state), _t(u), _t(w))
        want = jf.motion_update(jcfg, jnp.asarray(state), jnp.asarray(u),
                                jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
        got = tf.uncertainty_update(tcfg, _t(state), _t(cov), _t(u))
        want = jf.uncertainty_update(jcfg, jnp.asarray(state),
                                     jnp.asarray(cov), jnp.asarray(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    out = tf.motion_update(tcfg, torch.zeros(9, dtype=torch.float64),
                           _t([0.5, 0.1]), torch.zeros(3, dtype=torch.float64))
    th, vx = 0.5, 0.1
    np.testing.assert_allclose(
        out[:3].numpy(),
        [th, (-vx / th) * np.sin(th) + (vx / th) * np.sin(2 * th),
         (vx / th) * np.cos(th) - (vx / th) * np.cos(2 * th)], atol=1e-12)


def test_sparse_h_algebra_matches_dense_jacobian_and_tpunav():
    """The update's (2, 5)-block algebra against the dense (2, S) H on a
    random symmetric covariance, and Hσ̄, Ψ, ẑ, δz, the 2x2 inverse, the
    Kalman update and a new landmark against ``tpunav``'s (float64)."""
    jcfg, tcfg = _cfgs(num_landmarks=6)
    s = tcfg.state_size
    rng = np.random.default_rng(7)
    state = rng.normal(0.0, 1.0, s)
    a = rng.normal(0.0, 1.0, (s, s))
    cov = a @ a.T + np.eye(s)
    r_m, b_m = 1.3, 0.4
    v_i = np.array([1e-3, -2e-3])
    k = tf._update_consts(tcfg, _t(state))
    b_norm = normalize_angle_pi(_t(b_m))
    heading = tf._heading(_t(state), _t(v_i))
    d_all = tf._maha_all(tcfg, k, _t(state), _t(cov), _t(r_m), b_norm,
                         _t(v_i), heading, torch.ones(6, dtype=torch.bool))
    jd_all = jf._maha_all(jcfg, jnp.asarray(state), jnp.asarray(cov), r_m,
                          b_m, jnp.asarray(v_i), jnp.ones(6, bool))
    np.testing.assert_allclose(d_all.numpy(), np.asarray(jd_all), rtol=1e-9)
    for j in range(6):
        idx = k.h_table[j]
        jj = jnp.asarray(j, jnp.int32)
        H = tf._measurement_jacobian(tcfg, k, _t(state), idx).numpy()
        np.testing.assert_allclose(
            H, np.asarray(jf._measurement_jacobian(jcfg, jnp.asarray(state),
                                                   jj)), rtol=1e-12)
        block = tf._h_block(k, tf._h_terms(_t(state), idx))
        hc = tf._hc(_t(cov), block, idx)
        np.testing.assert_allclose(hc.numpy(), H @ cov, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(tf._psi_hh(hc, block, idx).numpy(),
                                   H @ cov @ H.T, rtol=1e-9, atol=1e-9)
        z_hat = tf._predicted_measurement(_t(state), idx, _t(v_i))
        np.testing.assert_allclose(
            z_hat.numpy(), np.asarray(jf._predicted_measurement(
                jnp.asarray(state), jj, jnp.asarray(v_i))), atol=1e-12)
        dz = torch.stack(tf._innovation(_t(r_m), b_norm, z_hat)).numpy()
        psi = H @ cov @ H.T + np.diag(tcfg.measurement_noise)
        np.testing.assert_allclose(
            tf._inv2(_t(psi)).numpy(), np.linalg.inv(psi), rtol=1e-9)
        np.testing.assert_allclose(float(d_all[j]),
                                   dz @ np.linalg.inv(psi) @ dz, rtol=1e-8)
        got = tf._kalman_update(tcfg, k, _t(state), _t(cov), idx, _t(r_m),
                                b_norm, _t(v_i), heading)
        want = jf._kalman_update(jcfg, jnp.asarray(state), jnp.asarray(cov),
                                 jj, r_m, b_m, jnp.asarray(v_i))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9)
        np.testing.assert_allclose(
            tf._new_landmark(_t(state), idx, _t(r_m), _t(b_m)).numpy(),
            np.asarray(jf._new_landmark(jnp.asarray(state), jj, r_m, b_m)),
            atol=1e-12)


def _maha(tcfg, state, cov, r, b, active):
    """The port's _maha_all (float64, no measurement noise)."""
    st, v = _t(state), torch.zeros(2, dtype=torch.float64)
    return tf._maha_all(tcfg, tf._update_consts(tcfg, st), st, _t(cov),
                        _t(r), normalize_angle_pi(_t(b)), v,
                        tf._heading(st, v), torch.as_tensor(active)).numpy()


def test_maha_all_inf_and_clamp():
    """+inf for a non-finite d² and for d² < −1e-6, 0 for a tiny negative,
    +inf for an inactive slot — equal to ``tpunav``'s."""
    jcfg, tcfg = _cfgs(num_landmarks=4, measurement_noise=(0.0, 0.0))
    s = tcfg.state_size
    state = np.zeros(s)
    state[3:] = [1.0, 0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 0.5]   # slot 2 at pose
    cov = np.eye(s)
    cov[7, 7] = cov[8, 8] = -1.0                            # slot 2 indefinite
    cov[9, 9] = cov[10, 10] = -4.0                          # slot 3 negative
    active = np.array([True, True, True, False])
    for r, b in [(1.0, 0.0), (1.0, 1.5), (0.5, 0.2)]:
        got = _maha(tcfg, state, cov, r, b, active)
        want = np.asarray(jf._maha_all(jcfg, jnp.asarray(state),
                                       jnp.asarray(cov), r, b, jnp.zeros(2),
                                       jnp.asarray(active)))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[np.isfinite(got)],
                                   want[np.isfinite(want)], rtol=1e-9)
        assert np.isinf(got[2]) and np.isinf(got[3])
        assert (got >= 0).all()
    # A tiny negative d² clamps to 0 in both.
    d = _maha(tcfg, state, cov, 1.0 - 1e-12, 0.0, active)
    assert d[0] >= 0.0


# ------------------------------------------------------- float64 courses --

@pytest.mark.parametrize("known", [True, False])
def test_float64_courses_match_tpunav_and_the_c_oracle(known):
    kw, course, u = COURSES[known]
    jcfg, tcfg = _cfgs(**kw)
    n = tcfg.num_landmarks
    jstep, tstep = _jstep(jcfg, known), _tstep(known)
    jst, st = jf.ekf_init(jcfg), _init(tcfg)
    c_state, c_cov = np.asarray(jst.state), np.asarray(jst.cov)
    c_active, c_count = np.asarray(jst.active), 0
    for meas in course():
        jst = jstep(jst, jnp.asarray(meas), jnp.asarray(u))
        st = tstep(tcfg, st, _t(meas), _t(u))
        if known:
            c_state, c_cov, c_active = native.ekf_known_update(
                n, tcfg.measurement_noise, tcfg.motion_noise, c_state,
                c_cov, c_active, meas, u)
            c_count = int(c_active.sum())
        else:
            c_state, c_cov, c_active, c_count = native.ekf_unknown_update(
                n, tcfg.measurement_noise, tcfg.motion_noise, c_state,
                c_cov, c_active, c_count, tcfg.dmin, tcfg.dmax, meas, u)
        got = interop.ekf_state_to_numpy(st)
        assert got["state"].dtype == np.float64
        for ref_state, ref_cov, ref_active, ref_count in [
                (np.asarray(jst.state), np.asarray(jst.cov),
                 np.asarray(jst.active), int(jst.count)),
                (c_state, c_cov, c_active, c_count)]:
            np.testing.assert_array_equal(got["active"], ref_active)
            assert int(got["count"]) == ref_count
            np.testing.assert_allclose(got["state"], ref_state, rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(got["cov"], ref_cov, rtol=0,
                                       atol=1e-9)
    assert int(st.count) >= 4             # the course built a map


# ------------------------------------------------------- float32 courses --

def _gate_margin(tcfg, st64, meas, u):
    """The smallest relative distance of the float64 d* of any valid row of
    this update from dmin or dmax, replaying the port's unknown-DA chain."""
    meas, v_all, state, cov = tf._predict(tcfg, st64, _t(meas), _t(u), None)
    valid, r_all, b_all, bn_all = ekf_rows.polar_rows(meas)
    k = tf._update_consts(tcfg, state)
    carry = (state, cov, st64.active, st64.count)
    margin = np.inf
    for i in torch.nonzero(valid).flatten().tolist():
        cov = 0.5 * (carry[1] + carry[1].T)
        row = (r_all[i], b_all[i], bn_all[i], v_all[i])
        r, _, b_norm, v = row
        d = tf._maha_all(tcfg, k, carry[0], cov, r, b_norm, v,
                         tf._heading(carry[0], v), carry[2])
        dstar = 1e12 if int(carry[3]) == 0 else float(d.min())
        for gate in (tcfg.dmin, tcfg.dmax):
            margin = min(margin, abs(dstar - gate) / gate)
        carry = tf._unknown_row(tcfg, k, carry, row)
    return margin


def _f32_courses():
    """(known, kw, measurements, u): the two native courses, and the first
    60 updates of tests/test_ekf.py's course (12 landmarks, all visible)
    through the filter of BASELINE config 3 (examples/
    slam_mppi_closed_loop_demo.py:43-46) with unknown DA."""
    out = [(known, *COURSES[known]) for known in (True, False)]
    out = [(known, kw, course(), u) for known, kw, course, u in out]
    pose, meas = np.zeros(3), []
    u = (0.05, 0.02)
    for _ in range(60):
        pose = np.array([pose[0] + u[0], pose[1] + u[1] * np.cos(pose[0] +
                                                                  u[0]),
                         pose[2] + u[1] * np.sin(pose[0] + u[0])])
        rel = LANDMARKS - pose[1:3]
        c, s = np.cos(pose[0]), np.sin(pose[0])
        meas.append(np.stack([c * rel[:, 0] + s * rel[:, 1],
                              -s * rel[:, 0] + c * rel[:, 1]], -1))
    out.append((False, dict(num_landmarks=12, dmin=5e1, dmax=1e4,
                            spd_repair=False, motion_noise=(1e-6,) * 3,
                            measurement_noise=(1e-6, 1e-6)), meas, u))
    return out


@pytest.mark.parametrize("case", range(3))
def test_float32_courses_match_tpunav(case):
    known, kw, meas_seq, u = _f32_courses()[case]
    jcfg, tcfg = _cfgs(**kw)
    jstep, tstep = _jstep(jcfg, known), _tstep(known)
    jst = jf.ekf_init(jcfg, jnp.float32)
    st, st64 = _init(tcfg, torch.float32), _init(tcfg)
    flips = 0
    for meas in meas_seq:
        margin = None if known else _gate_margin(tcfg, st64, meas, u)
        jst = jstep(jst, jnp.asarray(meas, jnp.float32),
                    jnp.asarray(u, jnp.float32))
        st = tstep(tcfg, st, _t(meas, torch.float32), _t(u, torch.float32))
        st64 = tstep(tcfg, st64, _t(meas), _t(u))
        want = {name: np.asarray(getattr(jst, name))
                for name in jf.EKFState._fields}
        got = interop.ekf_state_to_numpy(st)
        assert got["state"].dtype == np.float32
        if not (np.array_equal(got["active"], want["active"]) and
                int(got["count"]) == int(want["count"])):
            # A gate decision may differ only at a float64 near-tie.
            assert margin is not None and margin < 1e-4, margin
            flips += 1
            st = interop.ekf_state_from_numpy(want, torch.float32, "cpu")
            continue
        np.testing.assert_allclose(got["state"][:3], want["state"][:3],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["state"][3:], want["state"][3:],
                                   rtol=0, atol=1e-4)
        scale = float(np.abs(want["cov"]).max())
        np.testing.assert_allclose(got["cov"], want["cov"], rtol=1e-3,
                                   atol=1e-7 * scale)
    assert flips <= 1
    assert int(st.count) >= 4


# ------------------------------------------ the slam loop's off-schedule --

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("known", [True, False])
def test_prediction_alone_equals_the_all_nan_step(dtype, known):
    """An update with no measurement rows (the slam loop's off-schedule
    tick) equals the step on all-NaN rows bit for bit, with and without
    the SPD repair, and ``tpunav``'s all-NaN step exactly (with the
    repair, which symmetrizes or repairs as the case needs)."""
    for spd_repair in (False, True):
        _prediction_case(dtype, known, spd_repair)


def _prediction_case(dtype, known, spd_repair):
    jcfg, tcfg = _cfgs(num_landmarks=6, spd_repair=spd_repair,
                       motion_noise=(1e-5,) * 3)
    rng = np.random.default_rng(1)
    state = rng.normal(size=15)
    a = rng.normal(size=(15, 15))
    cov = a @ a.T * 1e-3 + np.eye(15)
    active = np.array([True, False] * 3)
    st = tf.EKFState(_t(state, dtype), _t(cov, dtype),
                     torch.as_tensor(active), torch.tensor(3,
                                                           dtype=torch.int32))
    jst = jf.EKFState(jnp.asarray(state, JDT[dtype]),
                      jnp.asarray(cov, JDT[dtype]), jnp.asarray(active),
                      jnp.asarray(3, jnp.int32))
    step = _tstep(known)
    jstep = _jstep(jcfg, known) if spd_repair else None
    for u in ([0.03, 0.015], [0.0, 0.01]):
        none = step(tcfg, st, torch.empty((0, 2), dtype=dtype), _t(u, dtype))
        nan = step(tcfg, st, torch.full((6, 2), float("nan"), dtype=dtype),
                   _t(u, dtype))
        for name in ("state", "cov", "active", "count"):
            assert torch.equal(getattr(none, name), getattr(nan, name))
        if jstep is None:
            continue
        want = jstep(jst, jnp.full((6, 2), jnp.nan, JDT[dtype]),
                     jnp.asarray(u, JDT[dtype]))
        for name in ("state", "cov", "active", "count"):
            np.testing.assert_array_equal(getattr(none, name).numpy(),
                                          np.asarray(getattr(want, name)))


# ------------------------------------------------- tests/test_ekf.py ----

def test_known_da_initializes_and_keeps_pose():
    tcfg = tf.EKFConfig(num_landmarks=4)
    st = tf.known_correspondence_slam(
        tcfg, _init(tcfg), _t([[1.0, 0.0], [0.0, 2.0], [np.nan, np.nan],
                               [np.nan, np.nan]]), _t([0.0, 0.0]))
    lms, active = tf.landmark_map(tcfg, st)
    assert active.tolist() == [True, True, False, False]
    np.testing.assert_allclose(lms[:2].numpy(), [[1.0, 0.0], [0.0, 2.0]],
                               atol=1e-6)
    np.testing.assert_allclose(tf.robot_pose(st).numpy(), [0.0] * 3,
                               atol=1e-6)
    st = _init(tcfg)
    for _ in range(5):
        st = tf.known_correspondence_slam(tcfg, st,
                                          _t([[1.0, 0.0], [0.0, 2.0]]),
                                          _t([0.0, 0.0]))
    np.testing.assert_allclose(tf.robot_pose(st).numpy(), [0.0] * 3,
                               atol=1e-5)
    assert bool(spd.is_spd(st.cov))
    with pytest.raises(ValueError):          # more rows than slots
        tf.known_correspondence_slam(tcfg, st, torch.zeros(5, 2,
                                                           dtype=torch.float64),
                                     _t([0.0, 0.0]))


def _arc(cfg, steps, u_true, u_odom, step):
    """tests/test_ekf.py's closed loops: exact landmark measurements from
    the true arc, the filter fed ``u_odom``."""
    st = _init(cfg)
    pose = torch.zeros(3, dtype=torch.float64)
    dead = torch.zeros(3, dtype=torch.float64)
    lm = _t(LANDMARKS)
    zero = torch.zeros(3, dtype=torch.float64)
    for _ in range(steps):
        pose = tf.motion_update(cfg, pose, u_true, zero)
        dead = tf.motion_update(cfg, dead, u_odom, zero)
        meas = sensor.landmark_measurements(lm, pose, 5.0)
        st = step(cfg, st, meas, u_odom)
    return pose, dead, st


def test_known_da_closed_loop_beats_odometry():
    cfg = tf.EKFConfig(num_landmarks=12)
    u_true = _t([0.05, 0.02])
    pose, dead, st = _arc(cfg, 200, u_true, u_true + _t([0.002, 0.0008]),
                          tf.known_correspondence_slam)
    err_ekf = float(torch.linalg.norm(tf.robot_pose(st)[1:] - pose[1:]))
    err_odom = float(torch.linalg.norm(dead[1:] - pose[1:]))
    assert err_ekf < 0.02 and err_ekf < err_odom / 5, (err_ekf, err_odom)
    assert int(st.count) == 12


def test_unknown_da_gates_caps_and_closes_the_loop():
    cfg = tf.EKFConfig(num_landmarks=6, dmin=2e4, dmax=1e7)
    meas = _t([[1.0, 0.0], [0.0, 2.0]])
    st = tf.slam_unknown_da(cfg, _init(cfg), meas, _t([0.0, 0.0]))
    assert int(st.count) == 2
    st = tf.slam_unknown_da(cfg, st, meas, _t([0.0, 0.0]))
    assert int(st.count) == 2             # re-observing adds nothing
    lms, _ = tf.landmark_map(cfg, st)
    np.testing.assert_allclose(lms[:2].numpy(), [[1.0, 0.0], [0.0, 2.0]],
                               atol=1e-4)
    cap = tf.EKFConfig(num_landmarks=2)
    st = tf.slam_unknown_da(cap, _init(cap), _t([[1.0, 0.0], [0.0, 2.0],
                                                 [-3.0, 0.0], [0.0, -4.0]]),
                            _t([0.0, 0.0]))
    assert int(st.count) == 2
    cfg = tf.EKFConfig(num_landmarks=12)
    u = _t([0.05, 0.02])
    pose, _, st = _arc(cfg, 100, u, u, tf.slam_unknown_da)
    err = float(torch.linalg.norm(tf.robot_pose(st) - pose))
    assert err < 0.05 and int(st.count) == 12


def test_compaction_matches_uncompacted_order():
    """NaN-interleaved measurements give the same filter as the same valid
    rows at the front (tests/test_ekf.py:234)."""
    cfg = tf.EKFConfig(num_landmarks=8, dmin=5e1, dmax=1e4, spd_repair=False)
    u = _t([0.02, 0.01])
    lms = np.random.default_rng(3).uniform(-1.0, 1.0, (5, 2))

    def meas_at(pose, rows):
        c, s = np.cos(pose[0]), np.sin(pose[0])
        rel = lms - pose[1:3]
        out = np.full((8, 2), np.nan)
        out[rows] = np.stack([c * rel[:, 0] + s * rel[:, 1],
                              -s * rel[:, 0] + c * rel[:, 1]], -1)
        return _t(out)

    st_a, st_b = _init(cfg), _init(cfg)
    pose = np.zeros(3)
    for _ in range(6):
        pose = np.array([pose[0] + 0.02, pose[1] + 0.01 * np.cos(pose[0]),
                         pose[2] + 0.01 * np.sin(pose[0])])
        st_a = tf.slam_unknown_da(cfg, st_a, meas_at(pose, [1, 2, 4, 6, 7]),
                                  u)
        st_b = tf.slam_unknown_da(cfg, st_b, meas_at(pose, [0, 1, 2, 3, 4]),
                                  u)
    np.testing.assert_allclose(st_a.state.numpy(), st_b.state.numpy(),
                               atol=1e-9)
    assert int(st_a.count) == int(st_b.count)


def test_noise_draws_by_distribution():
    """With a generator the update draws w ~ N(0, motion_noise) and v ~
    N(0, measurement_noise): moments within 4σ/√n over 2·10⁴ draws; without
    one, zeros."""
    cfg = tf.EKFConfig(motion_noise=(1e-4, 4e-4, 9e-4),
                       measurement_noise=(1e-2, 4e-2))
    like = torch.zeros(3, dtype=torch.float64)
    gen = torch.Generator().manual_seed(2)
    n = 20_000
    w, v = tf._noise_draws(cfg, gen, n, like)
    assert w.shape == (3,) and v.shape == (n, 2)
    for col, var in zip(v.T, cfg.measurement_noise):
        std = var ** 0.5
        assert abs(float(col.mean())) < 4 * std / n ** 0.5
        assert abs(float(col.std()) - std) < 4 * std / (2 * n) ** 0.5
    ws = torch.stack([tf._noise_draws(cfg, gen, 0, like)[0]
                      for _ in range(n // 10)])
    for col, var in zip(ws.T, cfg.motion_noise):
        std = var ** 0.5
        assert abs(float(col.mean())) < 4 * std / (n // 10) ** 0.5
    w0, v0 = tf._noise_draws(cfg, None, 4, like)
    assert not bool(w0.any()) and not bool(v0.any()) and v0.shape == (4, 2)
    st = tf.known_correspondence_slam(tf.EKFConfig(num_landmarks=2),
                                      _init(tf.EKFConfig(num_landmarks=2)),
                                      _t([[1.0, 0.0]]), _t([0.1, 0.1]),
                                      generator=gen)
    assert bool(torch.isfinite(st.state).all())


def test_update_restores_the_callers_matmul_precision():
    cfg = tf.EKFConfig(num_landmarks=4)
    meas = _t([[1.0, 0.2], [0.3, 2.0]], torch.float32)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        a = tf.slam_unknown_da(cfg, _init(cfg, torch.float32), meas,
                               _t([0.1, 0.02], torch.float32))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    b = tf.slam_unknown_da(cfg, _init(cfg, torch.float32), meas,
                           _t([0.1, 0.02], torch.float32))
    assert torch.equal(a.state, b.state) and torch.equal(a.cov, b.cov)


# --------------------------------------------------------------- sensor --

def test_landmark_sensor_matches_tpunav():
    """Visibility NaN rows and the pose + measurement noise, drawn by
    ``tpunav`` from its key and injected into the port (float64)."""
    lm = np.concatenate([LANDMARKS, [[100.0, 0.0]]])
    pose = np.array([np.pi / 2, 0.3, -0.1])
    key = jax.random.PRNGKey(4)
    for pose_std in (0.0, 1e-2):
        want = np.asarray(jsensor.landmark_measurements(
            jnp.asarray(lm), jnp.asarray(pose), 1.0, key=key, noise_std=0.01,
            pose_noise_std=pose_std))
        k_meas, k_pose = (jax.random.split(key) if pose_std else (key, key))
        got = sensor.landmark_measurements(
            _t(lm), _t(pose), 1.0, noise_std=0.01, pose_noise_std=pose_std,
            noise=_t(jax.random.normal(k_meas, (len(lm), 2), jnp.float64)),
            pose_noise=_t(jax.random.normal(k_pose, (3,), jnp.float64)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
        assert np.isnan(want[-1]).all() and not np.isnan(want[0]).any()
    clean = sensor.landmark_measurements(_t([[1.0, 1.0]]),
                                         _t([np.pi / 2, 1.0, 0.0]), 5.0)
    np.testing.assert_allclose(clean.numpy(), [[1.0, 0.0]], atol=1e-12)
    gen = torch.Generator().manual_seed(0)
    noisy = sensor.landmark_measurements(_t([[1.0, 1.0]]),
                                         _t([np.pi / 2, 1.0, 0.0]), 5.0,
                                         generator=gen, noise_std=0.01)
    assert not np.allclose(noisy.numpy(), [[1.0, 0.0]], atol=1e-6)


def test_associate_known_matches_tpunav():
    rng = np.random.default_rng(6)
    pose = np.array([0.4, 0.1, -0.2])
    c, s = np.cos(pose[0]), np.sin(pose[0])
    rel = LANDMARKS - pose[1:]
    rf = np.stack([c * rel[:, 0] + s * rel[:, 1],
                   -s * rel[:, 0] + c * rel[:, 1]], -1)
    det = np.full((16, 2), np.nan)
    det[[3, 0, 9, 5, 12, 7]] = rf[[0, 2, 4, 6, 8, 10]] + rng.normal(
        scale=0.01, size=(6, 2))
    det[14] = [5.0, 5.0]                          # matches nothing
    got = sensor.associate_known(_t(det), _t(LANDMARKS), _t(pose)).numpy()
    want = np.asarray(jsensor.associate_known(
        jnp.asarray(det), jnp.asarray(LANDMARKS), jnp.asarray(pose)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=0)
    assert (~np.isnan(got).any(1)).sum() == 6


# -------------------------------------------------------------- interop --

def test_configs_and_state_carry_across():
    from tpunav.control.slam_loop import SlamLoopConfig as JSlam
    from tpunav.estimation.landmarks import LandmarkConfig as JLm
    from tpunav.estimation.landmarks import LaserProps as JProps
    from tpunav_torch.control.slam_loop import SlamLoopConfig
    from tpunav_torch.estimation.landmarks import LandmarkConfig, LaserProps

    for ours, theirs, example in [
            (tf.EKFConfig, jf.EKFConfig, jf.EKFConfig(num_landmarks=50,
                                                      dmax=3e3)),
            (SlamLoopConfig, JSlam, JSlam(sensor_every=4, use_fused=True,
                                          odom_bias=(1e-4, 1e-4))),
            (LandmarkConfig, JLm, JLm(max_clusters=32,
                                      props=JProps(num_beams=180)))]:
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
        got = interop.config_from_fields(ours, dataclasses.asdict(example))
        assert dataclasses.asdict(got) == dataclasses.asdict(example)
    lm = interop.config_from_fields(
        LandmarkConfig, dataclasses.asdict(JLm(props=JProps(range_max=2.0))))
    assert isinstance(lm.props, LaserProps) and lm.props.range_max == 2.0

    cfg = tf.EKFConfig(num_landmarks=3)
    for dtype in (torch.float64, torch.float32):
        st = tf.slam_unknown_da(cfg, _init(cfg, dtype),
                                _t([[1.0, 0.0]], dtype), _t([0.1, 0.1],
                                                            dtype))
        back = interop.ekf_state_from_numpy(interop.ekf_state_to_numpy(st),
                                            dtype, device="cpu")
        for name in tf.EKFState._fields:
            assert getattr(back, name).dtype == getattr(st, name).dtype
            assert torch.equal(getattr(back, name), getattr(st, name))


def _entry_points():
    from tpunav_torch.control.mppi import MPPIConfig
    from tpunav_torch.control.slam_loop import slam_loop_init

    cfg = tf.EKFConfig(num_landmarks=2)
    zeros = {n: np.zeros(()) for n in ("true_pose", "odom", "u", "wpt_idx",
                                       "visits", "ticks", "done")}
    ekf = {"state": np.zeros(7), "cov": np.eye(7), "active": np.zeros(2),
           "count": 0}
    return {
        "ekf_init": lambda: tf.ekf_init(cfg),
        "slam_loop_init": lambda: slam_loop_init(MPPIConfig(horizon=0.1),
                                                 cfg),
        "ekf_state_from_numpy": lambda: interop.ekf_state_from_numpy(
            ekf, torch.float64),
        "slam_loop_state_from_numpy":
            lambda: interop.slam_loop_state_from_numpy({**zeros, "ekf": ekf}),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()
