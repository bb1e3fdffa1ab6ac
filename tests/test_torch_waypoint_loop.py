"""The port's waypoint course (the slice as a whole) against ``tpunav``.

30 ticks of ``tpunav.control.waypoint_loop.course_tick`` (plain backend)
run beside the port's ``course_tick`` from the same state, carried across
with ``tpunav_torch.interop``. The test replays ``tpunav``'s key split and
``sample_perturbations`` in jax and hands each tick's noise to the port
through ``noise=``, on both port backends (``use_fused`` False and True;
on the CPU the fused one is the kernel's plain version). Also the course
tests of ``tests/test_waypoint_loop.py``, ported at K=64.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.control import mppi as jm
from tpunav.control import waypoint_loop as jw
from tpunav.models.cart import CartParams as JCartParams
from tpunav_torch import interop
from tpunav_torch.control.mppi import MPPIConfig
from tpunav_torch.control.mppi import cost_to_go as tm_cost_to_go
from tpunav_torch.control.mppi import rollout_losses as tm_rollout_losses
from tpunav_torch.control.waypoint_loop import (
    CourseConfig,
    course_init,
    course_tick,
    run_course,
    run_course_chunked,
)
from tpunav_torch.models.cart import CartParams
from tpunav_torch.runtime.config import load_waypoints
from tpunav_torch.sim.motor import MotorParams, track

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = CartParams(0.033, 0.160)
CFG = MPPIConfig(horizon=0.5, dt=0.01, rollouts=64)
COURSE = [(0.3, 0.0, 0.0), (0.3, 0.3, 1.57), (0.0, 0.3, 3.14),
          (0.0, 0.0, 0.0)]
# Per-tick bounds of the 30-tick comparison (float32 on both sides). The
# measured max |Δpose| over the 30 ticks is below 1e-7 on both backends.
POSE_ATOL = 1e-4
U_ATOL = 1e-4
# At λ=0.01 a row of the update is a near-hard argmin over K. Where the
# two best rollouts' cost-to-go lie a few float32 ulps apart, two float32
# evaluation orders may weight them differently, and that row of u then
# differs by O(0.1): this is float32 resolution, not a fault. Such a row
# is accepted only when the float64 cost-to-go of the tick shows the tie.
NEAR_TIE_ULPS = 16


def _tie_ulps(cfg, model, st_pre, wpt, noise_nkc):
    """Per horizon step: the gap between the two smallest float64
    cost-to-go values, in float32 ulps at their magnitude."""
    d = torch.float64
    loss, _ = tm_rollout_losses(cfg, model, st_pre.pose.to(d),
                                st_pre.u.to(d)[None] +
                                noise_nkc.transpose(0, 1).to(d), wpt.to(d))
    two = torch.topk(tm_cost_to_go(loss), 2, dim=1, largest=False).values
    gap = (two[:, 1] - two[:, 0]).numpy()
    return gap / np.spacing(two[:, 0].numpy().astype(np.float32))


# ------------------------------------------------- the slice vs tpunav ---

@pytest.mark.parametrize("use_fused", [False, True])
def test_course_ticks_match_tpunav(use_fused):
    kw = dict(horizon=0.5, dt=0.01, rollouts=256)
    jcfg = jm.MPPIConfig(**kw)
    jcourse = jw.CourseConfig(goal_thresh=0.1)
    jmodel = JCartParams(0.033, 0.160)
    wpts = load_waypoints(os.path.join(REPO, "configs",
                                       "real_waypoints.yaml"))
    jwpts = jnp.asarray(wpts, jnp.float32)
    jst = jw.course_init(jcfg, jnp.zeros(3, jnp.float32), seed=0)
    jtick = jax.jit(lambda st: jw.course_tick(jcfg, jcourse, jmodel, jwpts,
                                              st))

    cfg = interop.config_from_fields(MPPIConfig, dataclasses.asdict(jcfg))
    course = dataclasses.replace(
        interop.config_from_fields(CourseConfig,
                                   dataclasses.asdict(jcourse)),
        use_fused=use_fused)
    model = interop.config_from_fields(CartParams, jmodel._asdict())
    st = interop.course_state_from_numpy(
        {name: np.asarray(getattr(jst, name))
         for name in ("pose", "u", "wpt_idx", "visits", "ticks", "done",
                      "wheel_vel")}, device="cpu")
    twpts = torch.as_tensor(wpts, dtype=torch.float32)

    max_dpose = 0.0
    ties = {}            # u row → |Δ| of a near-tie row, carried by the shift
    for tick in range(30):
        _, sub = jax.random.split(jst.key)
        noise = torch.from_numpy(np.asarray(jm.sample_perturbations(
            jcfg, sub, dtype=jnp.float32)).transpose(1, 0, 2).copy())
        jst = jtick(jst)
        st_pre = st
        st = course_tick(cfg, course, model, twpts, st, noise=noise)
        got = interop.course_state_to_numpy(st)
        want = {k: np.asarray(getattr(jst, k)) for k in got}
        assert got["pose"].dtype == np.float32
        assert int(got["wpt_idx"]) == int(want["wpt_idx"]), tick
        assert int(got["visits"]) == int(want["visits"]), tick
        assert int(got["ticks"]) == int(want["ticks"]) == tick + 1
        assert bool(got["done"]) == bool(want["done"])
        np.testing.assert_allclose(got["pose"], want["pose"], rtol=0,
                                   atol=POSE_ATOL, err_msg=f"tick {tick}")
        max_dpose = max(max_dpose,
                        float(np.abs(got["pose"] - want["pose"]).max()))

        du = np.abs(got["u"] - want["u"]).max(axis=1)
        carried = {r - 1: d for r, d in ties.items() if r >= 1}
        ties = {}
        bad = np.nonzero(du > U_ATOL)[0]
        if len(bad):
            gaps = _tie_ulps(cfg, model, st_pre,
                             twpts[int(got["wpt_idx"])], noise)
        for r in bad:
            # u_next row r is update row r + 1 (the receding shift).
            if r in carried:
                assert du[r] <= carried[r] + U_ATOL, (tick, r)
            else:
                assert gaps[r + 1] < NEAR_TIE_ULPS, (tick, r, gaps[r + 1])
            ties[r] = du[r]
    assert len(ties) <= 1
    # The pentagon starts on waypoint 0, so the first tick advances it.
    assert int(got["visits"]) == 1 and int(got["wpt_idx"]) == 1
    assert np.abs(got["pose"]).max() > 1e-3          # the cart moved
    assert max_dpose < 1e-7


def test_interop_round_trip_and_configs():
    from tpunav.sim.motor import MotorParams as JMotor

    jcourse = jw.CourseConfig(goal_thresh=0.2, use_fused=True,
                              motor=JMotor(time_const=0.05))
    course = interop.config_from_fields(CourseConfig,
                                        dataclasses.asdict(jcourse))
    assert course.motor == MotorParams(time_const=0.05)
    assert dataclasses.asdict(course) == dataclasses.asdict(jcourse)
    st = course_init(CFG, [0.1, 0.2, 0.3], seed=4, device="cpu")
    back = interop.course_state_from_numpy(
        interop.course_state_to_numpy(st), device="cpu", seed=4)
    for name, val in interop.course_state_to_numpy(back).items():
        ref = getattr(st, name)
        assert getattr(back, name).dtype == ref.dtype
        np.testing.assert_array_equal(val, ref.numpy())
    assert back.seed == 4


# ------------------------------------------ tests/test_waypoint_loop.py --

@pytest.fixture(scope="module")
def finished():
    """One plain-backend course run to completion, shared by three tests."""
    course = CourseConfig(goal_thresh=0.1, max_ticks=6000)
    st0 = course_init(CFG, torch.zeros(3), seed=0, device="cpu")
    return course, st0, run_course(CFG, course, MODEL, COURSE, st0)


def test_run_course_completes(finished):
    _, _, out = finished
    assert bool(out.done), f"course incomplete after {int(out.ticks)} ticks"
    assert int(out.visits) == len(COURSE)
    # Ends near the last waypoint.
    assert float(torch.hypot(out.pose[0] - COURSE[-1][0],
                             out.pose[1] - COURSE[-1][1])) < 0.15


def test_chunked_matches_fused(finished):
    """Chunked execution is the same run split at chunk boundaries."""
    course, st0, out_a = finished
    # The fixture's run advanced st0's generator: restart the same stream.
    st0 = st0._replace(generator=torch.Generator().manual_seed(0))
    paths = []
    out_b = run_course_chunked(CFG, course, MODEL, COURSE, st0, chunk=100,
                               on_chunk=lambda s, p: paths.append(p))
    assert bool(out_b.done)
    assert int(out_a.visits) == int(out_b.visits)
    # The chunked run overshoots by < 1 chunk of no-op (done) ticks; poses
    # at completion agree (the done pose is frozen).
    np.testing.assert_allclose(out_a.pose.numpy(), out_b.pose.numpy(),
                               atol=1e-5)
    assert int(out_b.ticks) - int(out_a.ticks) < 100
    assert int(out_b.ticks) % 100 == 0
    # Per-tick telemetry: PRE-tick rows, starting at the initial state.
    tel = paths[0]
    assert tel["pose"].shape == (100, 3)
    assert tel["d2g"].shape == (100,)
    assert tel["wpt_idx"].shape == (100,)
    assert torch.equal(tel["pose"][0], st0.pose)
    assert float(tel["d2g"][0]) == pytest.approx(0.3)
    assert int(tel["wpt_idx"][0]) == 0


def test_done_freezes_pose(finished):
    """After the course completes, further ticks do not move the cart."""
    course, _, out = finished
    assert bool(out.done)
    wpts = torch.as_tensor(COURSE, dtype=torch.float32)
    out2 = course_tick(CFG, course, MODEL, wpts,
                       course_tick(CFG, course, MODEL, wpts, out))
    np.testing.assert_allclose(out2.pose.numpy(), out.pose.numpy(), atol=0)
    assert bool(out2.done)
    assert int(out2.ticks) == int(out.ticks) + 2


def test_course_with_motor_dynamics_completes():
    """A torque-capped first-order motor lag between command and plant:
    the course still closes all waypoints."""
    course = CourseConfig(goal_thresh=0.1, max_ticks=8000,
                          motor=MotorParams(time_const=0.05))
    st = course_init(CFG, torch.zeros(3), seed=0, device="cpu")
    out = run_course(CFG, course, MODEL, COURSE, st)
    assert bool(out.done), f"course incomplete after {int(out.ticks)} ticks"
    assert int(out.visits) == len(COURSE)


def test_motor_track_ramps_and_caps():
    p = MotorParams(time_const=0.1, max_torque=1.5, eff_inertia=2.4e-3)
    v = torch.zeros(2)
    cmd = torch.tensor([5.0, -5.0])
    dt = 1.0 / 200.0
    v1 = track(p, v, cmd, dt)
    # First-order step response, within the accel cap.
    expected = (1.0 - np.exp(-dt / p.time_const)) * 5.0
    assert abs(float(v1[0]) - min(expected, p.max_accel * dt)) < 1e-6
    assert float(v1[1]) == -float(v1[0])
    # Converges to the command.
    for _ in range(400):
        v = track(p, v, cmd, dt)
    np.testing.assert_allclose(v.numpy(), cmd.numpy(), atol=1e-2)
    # tau=0 is exact pass-through.
    assert torch.equal(track(MotorParams(), v, cmd, dt), cmd)


def test_course_tick_guards():
    wpts = torch.as_tensor(COURSE, dtype=torch.float32)
    st = course_init(CFG, torch.zeros(3), device="cpu")
    with pytest.raises(ValueError):     # obstacles are fused-kernel only
        course_tick(CFG, CourseConfig(use_fused=False), MODEL, wpts, st,
                    obstacles=torch.zeros(1, 5))
    with pytest.raises(ValueError):
        course_tick(CFG, CourseConfig(use_fused=True), MODEL, wpts, st,
                    extra_cost=lambda xy: xy[..., 0])
