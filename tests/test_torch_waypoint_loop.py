"""The port's waypoint course (the slice as a whole) against ``tpunav``.

30 ticks of ``tpunav.control.waypoint_loop.course_tick`` (plain backend)
run beside the port's ``course_tick`` from the same state, carried across
with ``tpunav_torch.interop``. The test replays ``tpunav``'s key split and
``sample_perturbations`` in jax and hands each tick's noise to the port
through ``noise=``, on both port backends (``use_fused`` False and True;
on the CPU the fused one is the kernel's plain version). Also the course
tests of ``tests/test_waypoint_loop.py``, ported at K=64.

The plain backend's replayed chunks (``capture.Graph``'s CPU path runs
the body the card replays) against the eager per-tick loop, bit for bit
with the generator: ``run_course`` stopping mid-chunk on done and on
``max_ticks``, ``run_course_chunked`` with its telemetry, with and
without an ``extra_cost``; and a chunk fed ``tpunav``'s perturbations
through its draw seam against ``tpunav``'s ``course_tick``.
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
from tpunav_torch.control import waypoint_loop as twl
from tpunav_torch.control.obstacle_cost import (SegmentCostParams,
                                                make_segment_obstacle_cost,
                                                segments_from_polygons)
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


# ------------------------------------- the plain backend's replayed chunks --

# A short course (~140 ticks) at a small width: K=32, N=10.
SMALL = MPPIConfig(horizon=0.2, dt=0.02, rollouts=32, ul_var=4.0,
                   ur_var=4.0)
SHORT = torch.tensor([[0.08, 0.0, 0.0], [0.08, 0.06, 1.57],
                      [0.0, 0.05, 3.14]])
FIELDS = ("pose", "u", "wpt_idx", "visits", "ticks", "done", "wheel_vel")


def _wall_cost():
    segs = segments_from_polygons(
        [[[-0.1, 0.11], [0.2, 0.11], [0.2, 0.13], [-0.1, 0.13]]],
        device="cpu")
    return make_segment_obstacle_cost(
        SegmentCostParams(r_safe=0.02, w_hit=1e6, w_field=1e2, sigma=0.02),
        segs, device="cpu")


def _short(max_ticks):
    return CourseConfig(goal_thresh=0.03, max_ticks=max_ticks)


def _plain_start():
    return course_init(SMALL, torch.zeros(3), seed=5, device="cpu")


def _same(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("chunk,max_ticks", [(50, 400), (30, 100)])
def test_plain_run_course_equals_eager_ticks(wall, chunk, max_ticks):
    """``run_course`` on the plain backend stops mid-chunk on done (~140
    ticks, chunks of 50) or on ``max_ticks`` (100, chunks of 30) in the
    eager per-tick loop's state, its generator where that loop leaves it
    (the held ticks' draws taken back)."""
    course = _short(max_ticks)
    extra = _wall_cost() if wall else None
    want = _plain_start()
    while int(want.ticks) < max_ticks and not bool(want.done):
        want = course_tick(SMALL, course, MODEL, SHORT, want,
                           extra_cost=extra)
    assert bool(want.done) == (max_ticks == 400)
    assert int(want.ticks) % chunk
    got = run_course(SMALL, course, MODEL, SHORT, _plain_start(),
                     extra_cost=extra, chunk=chunk)
    _same(got, want)


def test_plain_run_course_chunked_equals_eager_chunks():
    """``run_course_chunked`` on the plain backend: tpunav's scan, each
    chunk's state, telemetry and generator the eager chunked loop's, the
    copies handed to ``on_chunk`` unchanged by later chunks."""
    chunk, course = 50, _short(400)
    st, want = _plain_start(), []
    while True:
        rows = {"pose": [], "wpt_idx": [], "d2g": []}
        for _ in range(chunk):
            wpt = SHORT[int(st.wpt_idx)]
            rows["pose"].append(st.pose)
            rows["wpt_idx"].append(st.wpt_idx)
            rows["d2g"].append(torch.hypot(st.pose[0] - wpt[0],
                                           st.pose[1] - wpt[1]))
            st = course_tick(SMALL, course, MODEL, SHORT, st)
        gen = st.generator.get_state()
        want.append((st, {k: torch.stack(v) for k, v in rows.items()}, gen))
        if bool(st.done):
            break
    seen = []
    got = run_course_chunked(SMALL, course, MODEL, SHORT, _plain_start(),
                             chunk=chunk, on_chunk=lambda s, t: seen.append(
                                 (s, t, s.generator.get_state())))
    assert len(seen) == len(want) >= 3
    _same(got, want[-1][0])
    for (s, tel, gen), (ws, wtel, wgen) in zip(seen, want):
        for f in FIELDS:
            assert torch.equal(getattr(s, f), getattr(ws, f)), f
        assert torch.equal(gen, wgen)
        for name in ("pose", "wpt_idx", "d2g"):
            assert torch.equal(tel[name], wtel[name]), name


def test_plain_chunk_with_injected_noise_matches_tpunav():
    """Three plain ticks of one replayed chunk, fed tpunav's perturbations
    through the chunk's draw seam, against tpunav's ``course_tick`` at the
    30-tick comparison's bars (a near-tie row of u excepted, as there);
    and the port's eager ticks on the same noise, bit for bit."""
    kw = dict(horizon=0.5, dt=0.01, rollouts=128)
    jcfg, jcourse = jm.MPPIConfig(**kw), jw.CourseConfig(goal_thresh=0.1)
    jmodel = JCartParams(0.033, 0.160)
    wpts = load_waypoints(os.path.join(REPO, "configs",
                                       "real_waypoints.yaml"))
    jst = jw.course_init(jcfg, jnp.zeros(3, jnp.float32), seed=3)
    cfg = interop.config_from_fields(MPPIConfig, dataclasses.asdict(jcfg))
    course = interop.config_from_fields(CourseConfig,
                                        dataclasses.asdict(jcourse))
    st = interop.course_state_from_numpy(
        {name: np.asarray(getattr(jst, name)) for name in FIELDS},
        device="cpu")
    twpts = torch.as_tensor(wpts, dtype=torch.float32)
    noise = []
    for _ in range(3):
        _, sub = jax.random.split(jst.key)
        noise.append(torch.from_numpy(np.array(jm.sample_perturbations(
            jcfg, sub, dtype=jnp.float32))))
        jst = jw.course_tick(jcfg, jcourse, jmodel,
                             jnp.asarray(wpts, jnp.float32), jst)
    chunks = twl._Chunks(cfg, course, MODEL, twpts, st, None, None, 3,
                         held=False, telemetry=False)
    chunks.step(course.max_ticks, noise=torch.stack(noise))
    eager = st
    for z in noise:
        pre = eager
        eager = course_tick(cfg, course, MODEL, twpts, eager,
                            noise=z.transpose(0, 1))
    for f in FIELDS:
        assert torch.equal(getattr(chunks.state, f), getattr(eager, f)), f
    got = interop.course_state_to_numpy(chunks.state)
    assert int(got["ticks"]) == int(jst.ticks) == 3
    assert int(got["wpt_idx"]) == int(jst.wpt_idx)
    np.testing.assert_allclose(got["pose"], np.asarray(jst.pose), rtol=0,
                               atol=POSE_ATOL)
    du = np.abs(got["u"] - np.asarray(jst.u)).max(axis=1)
    bad = np.nonzero(du > U_ATOL)[0]
    if len(bad):
        gaps = _tie_ulps(cfg, MODEL, pre, twpts[int(got["wpt_idx"])],
                         noise[-1].transpose(0, 1))
        assert all(gaps[r + 1] < NEAR_TIE_ULPS for r in bad), (bad, gaps)
