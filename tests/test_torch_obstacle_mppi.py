"""The obstacle-aware MPPI course (BASELINE config 2) of the port against
``tpunav``.

On the CPU the fused solve's obstacle mode runs the kernel's plain version
(``ops/fused_mppi.py``); it is held against ``tpunav``'s Pallas kernel in
interpret mode with injected noise. The cost functions of
``control/obstacle_cost.py``, ``pack_obstacles`` and 30 course ticks with
obstacles are held against ``tpunav`` on the same inputs; the two tests of
``tests/test_obstacle_mppi.py`` run on the port's plain path. All float32,
as the course runs, except the float64 cost-to-go that shows near-ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunav.control import mppi as jm
from tpunav.control import obstacle_cost as joc
from tpunav.control import waypoint_loop as jw
from tpunav.models.cart import CartParams as JCartParams
from tpunav.ops import pallas_mppi as jp
from tpunav.planning import PlanningGrid as JPlanningGrid
from tpunav_torch import interop
from tpunav_torch.control import mppi as tm
from tpunav_torch.control import obstacle_cost as oc
from tpunav_torch.control.waypoint_loop import (CourseConfig, course_init,
                                                course_tick, run_course)
from tpunav_torch.models.cart import CartParams, kinematic_cart
from tpunav_torch.ops import fused_mppi as fm
from tpunav_torch.ops.rk4 import rk4_step
from tpunav_torch.planning import (PlanningGrid, RoadMap, load_obstacle_map,
                                   theta_star)

torch.set_num_threads(1)

MODEL = CartParams(0.033, 0.160)
J_MODEL = JCartParams(0.033, 0.160)
F32 = jnp.float32
WALL = [[[0.95, 0.7], [1.05, 0.7], [1.05, 1.3], [0.95, 1.3]]]
WALL_MAP = load_obstacle_map(WALL, bounds=[[0.0, 2.0], [0.0, 2.0]],
                             resolution=0.05)
# tests/test_pallas_mppi.py's circle plus wall, and the demo's wall.
CIRCLE_AND_WALL = np.array([[0.5, 0.1, 0.5, 0.1, 0.05],
                            [0.3, -0.4, 0.3, 0.4, 0.0]], np.float32)
DEMO_WALL = np.array([[0.95, 0.7, 1.05, 0.7, 0.0],
                      [1.05, 0.7, 1.05, 1.3, 0.0],
                      [1.05, 1.3, 0.95, 1.3, 0.0],
                      [0.95, 1.3, 0.95, 0.7, 0.0]], np.float32)
SETS = {
    "circle_and_wall": (CIRCLE_AND_WALL, (0.0, 0.0, 0.0), (1.0, 0.2, 0.0),
                        dict(r_safe=0.1, w_hit=1e6, w_field=1e3, sigma=0.2)),
    "demo_wall": (DEMO_WALL, (0.75, 1.0, 0.1), (1.8, 1.0, 0.0),
                  dict(r_safe=0.1, w_hit=1e7, w_field=2e3, sigma=0.05)),
}
# PR 1's near-tie rule (tests/test_torch_waypoint_loop.py) exempts a row
# of the update only where the float64 cost-to-go shows that float32
# rounding of J can move it. XLA's CPU code fuses multiply-adds and rounds
# exp apart from torch, so the two sides' float32 J differ, and row t of
# the cost-to-go sums N − t losses, so each side's J may lie up to
# ε_t = max(NEAR_TIE_ULPS, N − t) float32 ulps from the float64 value. A
# row may differ beyond rtol/atol where its two best rollouts lie within
# ε_t (rounding can swap them), or by what ε_t of every J moves it to
# first order where the softmax shares weight: (ε/λ)·Σ_k w_k·|z_k − ū|,
# from the float64 solve. Each case bounds how many rows may be exempt.
NEAR_TIE_ULPS = 16
R = fm._BLOCK                  # rollouts per block of the kernel


def _cfgs(k, n):
    kw = dict(horizon=n * 0.01, dt=0.01, rollouts=k)
    return jm.MPPIConfig(**kw), tm.MPPIConfig(**kw)


def _inputs(cfg, seed, u_off=(0.6, 0.4)):
    """float32 u and the port's time-major (N, K, 2) noise."""
    rng = np.random.default_rng(seed)
    sig = np.sqrt([cfg.ul_var, cfg.ur_var])
    noise = (rng.standard_normal((cfg.steps, cfg.rollouts, 2)) * sig
             ).astype(np.float32)
    u = (np.zeros((cfg.steps, 2)) + u_off).astype(np.float32)
    return u, noise


def _slack(cfg, u, pose, xd, noise_nkc, cost, partial=False):
    """From the float64 solve: per row t, whether its two best rollouts
    lie within ε_t, and per row and column how far ε_t of rounding in every
    cost-to-go value moves the update (N, 2), or with ``partial`` the
    partials (N, 6), to first order."""
    d = torch.float64
    z = noise_nkc.to(d)                                      # (N, K, 2)
    loss, _ = tm.rollout_losses(cfg, MODEL, pose.to(d),
                                u.to(d)[None] + z.transpose(0, 1), xd.to(d),
                                cost)
    j = tm.cost_to_go(loss)                                  # (N, K)
    n = j.shape[0]
    ulps = np.maximum(NEAR_TIE_ULPS, n - np.arange(n))       # ε_t in ulps
    two = torch.topk(j, min(2, j.shape[1]), dim=1, largest=False
                     ).values.numpy()
    # With one rollout there is no second best to tie with.
    tie = (two[:, -1] - two[:, 0] < ulps * np.spacing(
        two[:, 0].astype(np.float32))) & (two.shape[1] == 2)
    eps = torch.from_numpy(ulps[:, None] * np.spacing(
        j.numpy().astype(np.float32)).astype(np.float64))
    best = j.argmin(dim=1, keepdim=True)
    e = torch.exp((j.gather(1, best) - j) / cfg.lambda_)
    if partial:
        de = e * (eps + eps.gather(1, best)) / cfg.lambda_
        zero = torch.zeros_like(de[:, :1])
        slack = torch.cat([eps.gather(1, best), de.sum(1, keepdim=True),
                           torch.einsum("nk,nkc->nc", de, z.abs()), zero,
                           zero], dim=1)
        return tie, slack.numpy()
    w = e / e.sum(dim=1, keepdim=True)
    ubar = torch.einsum("nk,nkc->nc", w, z)
    return tie, torch.einsum("nk,nkc->nc", w * eps,
                             (z - ubar[:, None]).abs()).numpy() / cfg.lambda_


def _exempt_rows(got, want, rounding, rtol=1e-4, atol=1e-5):
    """Rows of (N, C) outputs outside rtol/atol; each must be a near-tie or
    stay within the first-order slack of rounding in J (``rounding`` is
    :func:`_slack`'s pair)."""
    tie, slack = rounding
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    bad = np.nonzero(~ok.all(axis=1))[0]
    for r in bad:
        err = np.abs(got[r] - want[r])
        assert tie[r] or np.all(
            err <= atol + rtol * np.abs(want[r]) + slack[r]), (
            r, got[r], want[r], slack[r])
    return len(bad)


def _solve_both(name, k, n, partial):
    segs, pose, xd, w = SETS[name]
    jcfg, cfg = _cfgs(k, n)
    u, noise = _inputs(cfg, seed=k + n)
    jparams = joc.SegmentCostParams(**w)
    params = oc.SegmentCostParams(**w)
    jargs = (jcfg, J_MODEL, jnp.asarray(u, F32), 0, jnp.asarray(pose, F32),
             jnp.asarray(xd, F32))
    jkw = dict(noise=jnp.asarray(noise.reshape(n, k // 128, 128, 2), F32),
               obstacles=jnp.asarray(segs), obs_cfg=jparams, interpret=True)
    tu, tnoise = torch.from_numpy(u), torch.from_numpy(noise)
    tpose, txd = torch.tensor(pose), torch.tensor(xd)
    targs = (cfg, MODEL, tu, 0, tpose, txd)
    tkw = dict(noise=tnoise, obstacles=torch.from_numpy(segs), obs_cfg=params)
    cost = oc.make_segment_obstacle_cost(params, segs, device="cpu")
    slack = _slack(cfg, tu, tpose, txd, tnoise, cost, partial)
    if partial:
        want = np.asarray(jp.mppi_solve_partials(*jargs, **jkw))
        got = fm.mppi_solve_partials(*targs, **tkw).numpy()
        return got, want, slack
    cmd_j, un_j = jp.mppi_solve_fused(*jargs, **jkw)
    cmd, un = fm.mppi_solve_fused(*targs, **tkw)
    assert cmd.dtype == torch.float32 and un.shape == (n, 2)
    np.testing.assert_array_equal(un[-1].numpy(), 0.0)
    # The update before the shift: row 0 is the command, rows 1.. u_next.
    got = torch.cat([cmd[None], un[:-1]]).numpy()
    want = np.concatenate([np.asarray(cmd_j)[None], np.asarray(un_j)[:-1]])
    return got, want, slack


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("k,n", [(128, 25), (256, 25)])
def test_fused_obstacle_mode_matches_tpunav_kernel(name, k, n):
    got, want, slack = _solve_both(name, k, n, partial=False)
    assert _exempt_rows(got, want, slack) <= 1


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("k", [128, 256])
def test_obstacle_partials_match_tpunav_row_for_row(name, k):
    got, want, slack = _solve_both(name, k, 25, partial=True)
    assert got.shape == (25, 6)
    # m_l, the rows' min cost-to-go, agrees everywhere.
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4, atol=1e-5)
    assert _exempt_rows(got, want, slack) <= 1


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("k", [1, R - 1, R + 1, 3 * R + 5, 128])
def test_obstacle_block_decomposition_matches_tpunav(name, k):
    """The plain version's 32-rollout blocks, the last one ragged and
    masked, with obstacles, over a horizon of 70 steps (longer than one of
    the kernel's 64-step chunks): against ``tpunav``'s Pallas kernel in
    interpret mode at K=128, and where that kernel takes no such K, against
    ``tpunav``'s XLA solver with ``make_segment_obstacle_cost`` on the same
    noise. Near-tie rows as above."""
    n = 70
    if k % 128 == 0:
        got, want, slack = _solve_both(name, k, n, partial=False)
        assert _exempt_rows(got, want, slack) <= 1
        return
    segs, pose, xd, w = SETS[name]
    jcfg, cfg = _cfgs(k, n)
    u, noise = _inputs(cfg, seed=k + n)
    ju, jnoise = jnp.asarray(u, F32), jnp.asarray(noise.transpose(1, 0, 2))
    jcost = joc.make_segment_obstacle_cost(joc.SegmentCostParams(**w),
                                           jnp.asarray(segs))
    loss, _ = jm.rollout_losses(jcfg, J_MODEL, jnp.asarray(pose, F32),
                                ju[None] + jnoise, jnp.asarray(xd, F32),
                                jcost)
    want = np.asarray(jm.update_controls(jcfg, ju, jnoise,
                                         jm.cost_to_go(loss)))
    params = oc.SegmentCostParams(**w)
    tu, tnoise = torch.from_numpy(u), torch.from_numpy(noise)
    tpose, txd = torch.tensor(pose), torch.tensor(xd)
    cmd, un = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd, noise=tnoise,
                                  obstacles=torch.from_numpy(segs),
                                  obs_cfg=params)
    got = torch.cat([cmd[None], un[:-1]]).numpy()
    cost = oc.make_segment_obstacle_cost(params, segs, device="cpu")
    assert _exempt_rows(got, want, _slack(cfg, tu, tpose, txd, tnoise,
                                          cost)) <= 1


def test_obstacle_mode_prices_the_wall():
    """The obstacle term changes the solve, and O=0 is the plain solve."""
    _, cfg = _cfgs(128, 25)
    u, noise = _inputs(cfg, seed=1)
    args = (cfg, MODEL, torch.from_numpy(u), 0, torch.tensor([0.75, 1.0, 0.0]),
            torch.tensor([1.8, 1.0, 0.0]))
    params = oc.SegmentCostParams(0.1, 1e7, 2e3, 0.05)
    noise = torch.from_numpy(noise)
    _, plain = fm.mppi_solve_fused(*args, noise=noise)
    _, walled = fm.mppi_solve_fused(*args, noise=noise,
                                    obstacles=torch.from_numpy(DEMO_WALL),
                                    obs_cfg=params)
    _, empty = fm.mppi_solve_fused(*args, noise=noise,
                                   obstacles=torch.zeros(0, 5),
                                   obs_cfg=params)
    assert torch.equal(empty, plain)
    assert not torch.allclose(walled, plain, atol=1e-3)


def test_obstacle_plain_version_equals_plain_solver_with_segment_cost():
    """At any K the fused plain version with obstacles is the plain solver
    with ``make_segment_obstacle_cost`` (association aside), K=200 ragged."""
    _, cfg = _cfgs(200, 20)
    u, noise = _inputs(cfg, seed=4)
    segs, pose, xd, w = SETS["circle_and_wall"]
    params = oc.SegmentCostParams(**w)
    tu, tnoise = torch.from_numpy(u), torch.from_numpy(noise)
    tpose, txd = torch.tensor(pose), torch.tensor(xd)
    cost = oc.make_segment_obstacle_cost(params, segs, device="cpu")
    cmd_f, un_f = fm.mppi_solve_fused(cfg, MODEL, tu, 0, tpose, txd,
                                      noise=tnoise,
                                      obstacles=torch.from_numpy(segs),
                                      obs_cfg=params)
    cmd, un = tm.mppi_solve(cfg, MODEL, tu, None, tpose, txd, cost,
                            noise=tnoise.transpose(0, 1))
    slack = _slack(cfg, tu, tpose, txd, tnoise, cost)
    got = torch.cat([cmd_f[None], un_f[:-1]]).numpy()
    want = torch.cat([cmd[None], un[:-1]]).numpy()
    assert _exempt_rows(got, want, slack) <= 1


# ------------------------------------------------ cost fields, packing ---

def _points():
    g = np.linspace(-0.1, 2.1, 45)
    xy = np.stack(np.meshgrid(g, g), axis=-1).reshape(-1, 2)
    return xy.astype(np.float32)


def _assert_cost_close(got, want, w):
    """rtol 1e-6, plus what two float32 ulps of the distance d move the
    field term by: 2·ulp(d)/σ of the cost (7.6e-6 at d ≈ 1.5, σ = 0.05).
    XLA's fused multiply-adds round d apart from torch's elementwise ops,
    and exp(−(d − r_safe)/σ) scales that by 1/σ. d is recovered from the
    field term w_field·exp(−(d − r_safe)/σ) of the reference's cost."""
    field = want.astype(np.float64) - w["w_hit"] * (want >= w["w_hit"])
    d = w["r_safe"] - w["sigma"] * np.log(np.maximum(field, 1e-38) /
                                          w["w_field"])
    ulp_d = np.spacing(np.abs(d).astype(np.float32)).astype(np.float64)
    rtol = 1e-6 + 2 * ulp_d / w["sigma"]
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= rtol * np.abs(want)), float(
        (err / np.abs(want)).max())


@pytest.mark.parametrize("segs", [DEMO_WALL, CIRCLE_AND_WALL])
def test_segment_cost_matches_tpunav(segs):
    w = dict(r_safe=0.1, w_hit=1e7, w_field=2e3, sigma=0.05)
    xy = _points()
    want = np.asarray(joc.make_segment_obstacle_cost(
        joc.SegmentCostParams(**w), jnp.asarray(segs))(jnp.asarray(xy)))
    got = oc.make_segment_obstacle_cost(oc.SegmentCostParams(**w), segs,
                                        device="cpu")(torch.from_numpy(xy))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _assert_cost_close(got.numpy(), want, w)


def test_esdf_cost_matches_tpunav():
    grid_j = JPlanningGrid(WALL_MAP, inflation=0.0)
    # tpunav labels in float64 here (the tests turn on jax's x64 mode).
    grid = PlanningGrid(WALL_MAP, inflation=0.0, device="cpu",
                        dtype=torch.float64)
    np.testing.assert_array_equal(grid.labels, grid_j.labels)
    field_j = np.asarray(joc.distance_field_from_labels(grid_j.labels,
                                                        grid_j.resolution))
    field = oc.distance_field_from_labels(grid.labels, grid.resolution,
                                          device="cpu")
    assert field.dtype == torch.float32
    np.testing.assert_array_equal(field.numpy(), field_j)
    w = dict(xmin=grid.xmin, ymin=grid.ymin, resolution=grid.resolution,
             r_safe=0.1, w_hit=1e7, w_field=5e3, sigma=0.1)
    xy = _points()
    want = np.asarray(joc.make_obstacle_cost(joc.ObstacleCostConfig(**w),
                                             jnp.asarray(field_j))(
        jnp.asarray(xy)))
    got = oc.make_obstacle_cost(interop.config_from_fields(
        oc.ObstacleCostConfig, dataclasses.asdict(joc.ObstacleCostConfig(
            **w))), field)(torch.from_numpy(xy))
    _assert_cost_close(got.numpy(), want, w)


def test_segments_and_pack_match_tpunav_bit_for_bit():
    params_j = joc.SegmentCostParams(r_safe=0.1, w_hit=1e7, w_field=2e3,
                                     sigma=0.05)
    params = interop.config_from_fields(oc.SegmentCostParams,
                                        dataclasses.asdict(params_j))
    assert params == oc.SegmentCostParams(0.1, 1e7, 2e3, 0.05)
    segs_j = np.asarray(joc.segments_from_polygons(WALL))
    segs = oc.segments_from_polygons(WALL, device="cpu")
    np.testing.assert_array_equal(segs.numpy(), segs_j)
    np.testing.assert_array_equal(segs.numpy(), DEMO_WALL)
    circ_j = np.asarray(joc.segments_from_circles(
        jnp.array([[0.5, 0.1]]), jnp.array([0.05])))
    circ = oc.segments_from_circles([[0.5, 0.1]], [0.05], device="cpu")
    np.testing.assert_array_equal(circ.numpy(), circ_j)
    for s in (segs_j, CIRCLE_AND_WALL, np.zeros((0, 5), np.float32)):
        want = np.asarray(jp.pack_obstacles(jnp.asarray(s), params_j))
        got = fm.pack_obstacles(torch.tensor(s), params, device="cpu")
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert fm.pack_obstacles(None, None, device="cpu") is None
    with pytest.raises(ValueError):
        fm.pack_obstacles(segs, None, device="cpu")
    with pytest.raises(ValueError):
        fm.pack_obstacles(None, params, device="cpu")
    with pytest.raises(ValueError):
        fm.pack_obstacles(segs[:, :4], params, device="cpu")


# ------------------------------------------- the course with obstacles ---

START = (0.839, 1.0, 0.0)


@pytest.mark.parametrize("use_fused", [False, True])
def test_obstacle_course_ticks_match_tpunav(use_fused):
    """30 ticks from 1.1 cm outside the wall's r_safe band, driving at it.
    ``tpunav``'s plain backend with ``extra_cost`` is the reference; the
    port's plain backend takes the same ``extra_cost``, its fused backend
    ``obstacles``/``obs_cfg``. The noise is ``tpunav``'s key-split draw,
    replayed through ``noise=``. Each port tick starts from ``tpunav``'s
    state, carried across by ``interop``: near the wall the field's slope
    (w_field/σ = 4e4 per metre) can turn a last-bit pose difference into a
    δJ of several λ, so closed-loop rounding would compound tick by
    tick."""
    kw = dict(horizon=0.5, dt=0.01, rollouts=256)
    jcfg = jm.MPPIConfig(**kw)
    jcourse = jw.CourseConfig(goal_thresh=0.1)
    w = dict(r_safe=0.1, w_hit=1e7, w_field=2e3, sigma=0.05)
    wpts = np.array([[1.0, 0.5, 0.0], [1.8, 1.0, 0.0]], np.float32)
    jcost = joc.make_segment_obstacle_cost(joc.SegmentCostParams(**w),
                                           jnp.asarray(DEMO_WALL))
    jst = jw.course_init(jcfg, jnp.asarray(START, F32), seed=0)
    jst = jst._replace(u=jst.u + 3.0)     # driving at the wall at 0.1 m/s
    jtick = jax.jit(lambda st: jw.course_tick(
        jcfg, jcourse, J_MODEL, jnp.asarray(wpts), st, extra_cost=jcost))

    cfg = interop.config_from_fields(tm.MPPIConfig, dataclasses.asdict(jcfg))
    course = dataclasses.replace(
        interop.config_from_fields(CourseConfig, dataclasses.asdict(jcourse)),
        use_fused=use_fused)
    params = oc.SegmentCostParams(**w)
    cost = oc.make_segment_obstacle_cost(params, DEMO_WALL, device="cpu")
    obs = (dict(obstacles=torch.from_numpy(DEMO_WALL), obs_cfg=params)
           if use_fused else dict(extra_cost=cost))
    twpts = torch.from_numpy(wpts)
    names = ("pose", "u", "wpt_idx", "visits", "ticks", "done", "wheel_vel")

    # The wall lies within one horizon: rollouts of the first tick hit it.
    _, traj = tm.rollout_losses(
        cfg, MODEL, torch.tensor(START),
        torch.tensor(np.asarray(jst.u))[None] + torch.tensor(
            np.asarray(jm.sample_perturbations(jcfg, jax.random.split(
                jst.key)[1], dtype=F32))), twpts[0])
    assert int((cost(traj[..., :2]) >= w["w_hit"]).sum()) > 0
    exempt = 0
    for tick in range(30):
        _, sub = jax.random.split(jst.key)
        noise = torch.from_numpy(np.asarray(jm.sample_perturbations(
            jcfg, sub, dtype=F32)).transpose(1, 0, 2).copy())
        st_pre = interop.course_state_from_numpy(
            {name: np.asarray(getattr(jst, name)) for name in names},
            device="cpu")
        jst = jtick(jst)
        st = course_tick(cfg, course, MODEL, twpts, st_pre, noise=noise,
                         **obs)
        got = interop.course_state_to_numpy(st)
        want = {k: np.asarray(getattr(jst, k)) for k in got}
        assert int(got["wpt_idx"]) == int(want["wpt_idx"]), tick
        assert int(got["ticks"]) == int(want["ticks"]) == tick + 1
        wpt = twpts[int(got["wpt_idx"])]
        slack = _slack(cfg, st_pre.u, st_pre.pose, wpt, noise, cost)
        # The update before the shift: u_next row r is update row r + 1.
        upd = np.concatenate([got["wheel_vel"][None], got["u"][:-1]])
        upd_j = np.concatenate([want["wheel_vel"][None], want["u"][:-1]])
        exempt += _exempt_rows(upd, upd_j, slack)
        np.testing.assert_allclose(got["pose"], want["pose"], rtol=0,
                                   atol=1e-4, err_msg=f"tick {tick}")
        # The executed pose never enters the r_safe band.
        assert float(cost(torch.from_numpy(got["pose"][:2]))) < w["w_hit"]
    assert exempt <= 10          # of the 30 × 50 update rows


def test_course_tick_obstacle_guards_and_pack_once():
    cfg = tm.MPPIConfig(horizon=0.1, dt=0.01, rollouts=128)
    wpts = torch.tensor([[1.8, 1.0, 0.0]])
    st = course_init(cfg, torch.tensor([0.7, 1.0, 0.0]), device="cpu")
    params = oc.SegmentCostParams(0.1, 1e7, 2e3, 0.05)
    segs = torch.from_numpy(DEMO_WALL)
    with pytest.raises(ValueError):
        course_tick(cfg, CourseConfig(use_fused=False), MODEL, wpts, st,
                    obstacles=segs, obs_cfg=params)
    with pytest.raises(ValueError):
        course_tick(cfg, CourseConfig(use_fused=True), MODEL, wpts, st,
                    obstacles=segs)
    with pytest.raises(ValueError):
        run_course(cfg, CourseConfig(use_fused=False, max_ticks=2), MODEL,
                   wpts, st, obs_cfg=params)
    # run_course packs the table once and gives the same ticks as
    # course_tick, which packs per call.
    course = CourseConfig(use_fused=True, max_ticks=3)
    out = run_course(cfg, course, MODEL, wpts, st, obstacles=segs,
                     obs_cfg=params)
    ref = st
    for _ in range(3):
        ref = course_tick(cfg, course, MODEL, wpts, ref, obstacles=segs,
                          obs_cfg=params)
    assert int(out.ticks) == 3
    assert torch.equal(out.pose, ref.pose) and torch.equal(out.u, ref.u)


# ------------------------------------------ tests/test_obstacle_mppi.py --

def _cost_fn():
    grid = PlanningGrid(WALL_MAP, inflation=0.0, device="cpu")
    field = oc.distance_field_from_labels(grid.labels, grid.resolution,
                                          device="cpu")
    cfg = oc.ObstacleCostConfig(xmin=grid.xmin, ymin=grid.ymin,
                                resolution=grid.resolution, r_safe=0.1,
                                w_hit=1e7, w_field=5e3, sigma=0.1)
    return oc.make_obstacle_cost(cfg, field)


def test_cost_field_values():
    cost = _cost_fn()
    # On the wall → huge; far away → small.
    assert float(cost(torch.tensor([1.0, 1.0]))) > 1e6
    assert float(cost(torch.tensor([0.2, 1.9]))) < 1e4


def test_mppi_with_planner_waypoints_avoids_wall():
    """BASELINE config 2 on the port's plain path: Theta* routes around the
    wall and the ESDF cost keeps the rollouts clear of it. The roadmap is
    ``tpunav``'s seed-2 one, carried across by ``interop.roadmap_from_numpy``
    (the port draws its own nodes, and its seed-2 route turns 0.24 m from
    the wall's corner, where this field holds the cart outside that
    waypoint's 0.2 m arrival radius). The port draws its own noise, so the
    outcome is compared: the final goal is reached and the cart never
    enters the wall."""
    from tpunav.planning import RoadMap as JRoadMap

    cost = _cost_fn()
    own = RoadMap(WALL_MAP, n_nodes=80, k_neighbors=10, clearance=0.18,
                  seed=2)
    route = theta_star(own, own.add_node([0.2, 1.0]),
                       own.add_node([1.8, 1.0]))
    assert route is not None and len(route) >= 3  # detours via waypoints
    nodes = JRoadMap(WALL_MAP, n_nodes=80, k_neighbors=10, clearance=0.18,
                     seed=2).nodes
    rm = interop.roadmap_from_numpy(WALL_MAP, nodes, k_neighbors=10,
                                    clearance=0.18)
    s_idx = rm.add_node([0.2, 1.0])
    g_idx = rm.add_node([1.8, 1.0])
    assert s_idx is not None and g_idx is not None
    route = theta_star(rm, s_idx, g_idx)
    assert route is not None and len(route) >= 3

    cfg = tm.MPPIConfig(lambda_=0.05, ul_var=4.0, ur_var=4.0, horizon=1.0,
                        dt=0.05, rollouts=512, q_diag=(2e3, 2e3, 0.0),
                        r_diag=(0.05, 0.05), p1_diag=(1e3, 1e3, 0.0))
    u = tm.init_controls(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    pose = torch.tensor([0.2, 1.0, 0.0])
    f = lambda x, uu: kinematic_cart(MODEL, x, uu)

    wp_idx = 1                     # route[0] is the start itself
    reached = False
    for i in range(1500):
        gx, gy = route[wp_idx]
        final = wp_idx == len(route) - 1
        cmd, u = tm.mppi_solve(cfg, MODEL, u, gen, pose,
                               torch.tensor([gx, gy, 0.0],
                                            dtype=torch.float32), cost)
        pose = rk4_step(f, pose, cmd, 1.0 / 60.0)
        x, y = float(pose[0]), float(pose[1])
        assert not (0.95 <= x <= 1.05 and 0.7 <= y <= 1.3), (x, y, i)
        # Intermediate waypoints get a loose arrival radius, as in tpunav's
        # test: near the wall the field balances the tracking pull a little
        # short of the waypoint.
        if np.hypot(x - gx, y - gy) < (0.12 if final else 0.2):
            if final:
                reached = True
                break
            wp_idx += 1
    assert reached, f"never finished route; pose={pose.tolist()}"
