"""Config 4's seed sweep on the CPU: the public course runner
(``control.slam_loop.SlamCourseRunner``) against ``run_slam_course`` and
each seed's own eager course, a second sweep loaded in place with no new
graph; the port's config-4 tick against the plain reference
(``plain_ekf_dense.py``, a copy of the benchmark's
``navbench/reference/ekf_dense.py``, so that these tests need nothing of
the benchmark); and the tracer's phases in the runner's
graphs. ``capture.Graph`` runs each body without capture here: the bodies
the card replays. No JAX here: the port is held to itself and to the plain
reference."""

import math
import os

import pytest
import torch

import plain_ekf_dense as ref
from tpunav_torch import capture
from tpunav_torch.control import chunks
from tpunav_torch.control import slam_loop as sl
from tpunav_torch.runtime import profiling
from tpunav_torch.sim import dense_world as dw

torch.set_num_threads(2)

K = 64
CHUNK, TAIL = 12, 4          # a 28-tick course: two chunks and the tail


@pytest.fixture(scope="module")
def dep():
    return dw.deployment(K, device="cpu")


def _row(st):
    return torch.cat([st.ekf.state[:3], st.true_pose,
                      st.ekf.count.to(torch.float32)[None]])


def _batch(dep, seeds, tick0=0):
    st = sl.slam_batch_init(dep.mppi, dep.ekf, seeds,
                            pose_xyt=list(dep.start), device="cpu")
    st.ticks.add_(tick0 + torch.arange(len(seeds), dtype=torch.int32))
    return st


def _runner(dep, st):
    return sl.SlamCourseRunner(
        dep.mppi, dep.ekf, dep.loop, dep.model, dep.waypoints, dep.landmarks,
        st, chunk=CHUNK, tail=TAIL, meas_fn=dep.meas_fn,
        meas_shape=dep.meas_shape, telemetry=_row, device="cpu")


def _sweep(runner):
    rows = []
    for last in sl.course_plan(2 * CHUNK + TAIL, CHUNK)[2]:
        runner.run(tail=last)
        rows.append(runner.rows.clone())
    return torch.cat(rows, dim=1)


def _same_state(a, b):
    for f in sl._FIELDS:
        if f == "ekf":
            for x, y in zip(a.ekf, b.ekf):
                assert torch.equal(x, y)
        else:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def _copy(st):
    gens = tuple(torch.Generator().set_state(g.get_state())
                 for g in st.generator)
    return chunks.clone(st, sl._FIELDS)._replace(generator=gens)


def test_runner_equals_run_slam_course_and_each_serial_course(
        dep, monkeypatch):
    """The runner over two sweeps of 3 seeds (the second loaded in place,
    no graph made again): each sweep equals ``run_slam_course`` on the
    same batch, and seed 0 its own eager per-tick course, bit for bit."""
    made = []
    graph = capture.Graph

    class Counted(graph):
        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(sl.capture, "Graph", Counted)
    first, second = _batch(dep, [3, 5, 8]), _batch(dep, [11, 12, 13], 1000)
    runner = _runner(dep, _copy(first))
    assert len(made) == 2 and runner.state.host_ticks == 0
    ticks = 2 * CHUNK + TAIL
    for i, st in enumerate((first, second)):
        runner.load(_copy(st))
        rows = _sweep(runner)
        # No graph beyond the runner's two and run_slam_course's own.
        assert len(made) == 2 + 2 * i
        assert runner.state.host_ticks == ticks and rows.shape == (3, ticks,
                                                                   7)
        want, want_rows = sl.run_slam_course(
            dep.mppi, dep.ekf, dep.loop, dep.model, dep.waypoints,
            dep.landmarks, _copy(st), ticks, meas_fn=dep.meas_fn,
            meas_shape=dep.meas_shape, telemetry=_row, chunk=CHUNK)
        _same_state(runner.state, want)
        assert torch.equal(rows, want_rows)
        for a, b in zip(runner.state.generator, want.generator):
            assert torch.equal(a.get_state(), b.get_state())
    # Seed 0 of the second sweep, tick by tick on the eager path.
    one = sl.seed_state(_copy(second), 0)
    for t in range(ticks):
        one = sl.slam_loop_tick(dep.mppi, dep.ekf, dep.loop, dep.model,
                                dep.waypoints, dep.landmarks, one,
                                meas_fn=dep.meas_fn)
        assert torch.equal(_row(one), rows[0, t])
    _same_state(sl.seed_state(runner.state, 0), one)


def test_runner_checks():
    dep = dw.deployment(16, device="cpu")
    st = _batch(dep, [0, 1])
    with pytest.raises(ValueError, match="sensing tick"):
        sl.SlamCourseRunner(dep.mppi, dep.ekf, dep.loop, dep.model,
                            dep.waypoints, dep.landmarks,
                            st._replace(host_ticks=1), device="cpu")
    runner = sl.SlamCourseRunner(dep.mppi, dep.ekf, dep.loop, dep.model,
                                 dep.waypoints, dep.landmarks, st, chunk=2,
                                 device="cpu")
    with pytest.raises(ValueError, match="no tail"):
        runner.run(tail=True)
    runner.run()
    with pytest.raises(ValueError, match="sensing tick"):
        runner.run()                       # 2 ticks leave the schedule
    assert sl.course_plan(28, 12) == (12, 4, [False, False, True])
    assert sl.course_plan(24, 12) == (12, 0, [False, False])
    assert sl.course_plan(5, 12) == (5, 0, [False])


def _plain_solve(c, u, z, pose, xd):
    """MPPI's update with the injected perturbations z (N, K, 2), float32
    (the costs as the reference's MPPI cells take them)."""
    r, b, dt = c["wheel_radius"], c["wheel_base"], c["time_step"]
    n = z.shape[0]
    x, y, th = (pose[i].expand(z.shape[1]) for i in range(3))
    loss = []
    for t in range(n):
        ul, ur = u[t, 0] + z[t, :, 0], u[t, 1] + z[t, :, 1]
        w, v = (r / b) * (ur - ul), (r / 2.0) * (ul + ur)
        x = x + (dt / 6.0) * v * (torch.cos(th) + 4.0 * torch.cos(
            th + 0.5 * dt * w) + torch.cos(th + dt * w))
        y = y + (dt / 6.0) * v * (torch.sin(th) + 4.0 * torch.sin(
            th + 0.5 * dt * w) + torch.sin(th + dt * w))
        th = th + dt * w
        e = (x - xd[0], y - xd[1], th - xd[2])
        if t == n - 1:
            loss.append(sum(p * q * q for p, q in zip(c["P1"], e)))
        else:
            loss.append(sum(p * q * q for p, q in zip(c["Q"], e)) +
                        c["R"][0] * ul * ul + c["R"][1] * ur * ur)
    j = torch.flip(torch.cumsum(torch.flip(torch.stack(loss), (0,)), 0),
                   (0,))
    wts = torch.exp((j.amin(dim=1, keepdim=True) - j) / c["lambda"]) + 1e-8
    wts = wts / wts.sum(dim=1, keepdim=True)
    lim = c["max_rot_motor"]
    return torch.clamp(u + (wts[..., None] * z).sum(dim=1), -lim, lim)


def _plain_state(st):
    return ref.State(
        true_pose=st.true_pose, odom=st.odom, mu=st.ekf.state,
        cov=st.ekf.cov, active=st.ekf.active.tolist(),
        count=int(st.ekf.count), u=st.u, wpt_idx=int(st.wpt_idx),
        visits=int(st.visits), ticks=int(st.ticks), done=bool(st.done),
        host_ticks=st.host_ticks)


def _config(dep):
    """The plain reference's configuration, read off the package's
    deployment (the world's ring sizes as ``dense_world`` draws them)."""
    m, e, loop = dep.mppi, dep.ekf, dep.loop
    return {
        "ring_outer": 24, "ring_inner": 20, "r_outer": 1.55, "r_inner": 0.95,
        "inner_offset": 0.13, "waypoint_count": 12, "waypoint_r_in": 1.12,
        "waypoint_r_out": 1.42, "cyl_radius": dw.CYL_RADIUS,
        "beams": dw.NUM_BEAMS, "beam_min": 0.0, "beam_delta": math.pi / 180,
        "range_min": 0.12, "range_max": 3.5, "scan_noise": dw.SCAN_NOISE,
        "epsilon": 0.075, "radius_thresh": 0.05, "min_points": 4,
        "max_clusters": dw.MAX_CLUSTERS,
        "landmark_capacity": e.num_landmarks, "dmin": e.dmin,
        "dmax": e.dmax, "motion_noise": list(e.motion_noise),
        "measurement_noise": list(e.measurement_noise),
        "goal_thresh": loop.goal_thresh, "cycles": loop.cycles,
        "sensor_every": loop.sensor_every, "tick_dt": loop.tick_dt,
        "odom_bias": list(loop.odom_bias), "lambda": m.lambda_,
        "time_step": m.dt, "Q": list(m.q_diag), "R": list(m.r_diag),
        "P1": list(m.p1_diag), "max_rot_motor": m.max_wheel_vel,
        "ul_init": m.u_init[0], "ur_init": m.u_init[1],
        "wheel_radius": dep.model.wheel_radius,
        "wheel_base": dep.model.wheel_base,
        "tie_goal_m": 1e-6, "tie_cluster_m": 1e-6, "tie_radius_m": 1e-6,
        "tie_gate_rel": 1e-3, "tie_disc_m2": 1e-6, "tie_range_m": 1e-5}


def test_tick_equals_the_plain_reference(dep):
    """13 ticks of config 4 (sensing on ticks 0, 4, 8, 12, landmarks added
    on the first), each from the port's own state: the reference's tick
    against the port's. Bars: 2e-5 m and rad on the poses and 1e-5 m on
    the landmarks — float32 in other orders, which a ray grazing a
    cylinder magnifies in its range (up to ~1e-5 m, and so in a circle's
    centre); the count and the slots in use exactly. A tick whose
    reference meets a near-tie is skipped (none at this seed)."""
    c = _config(dep)
    lms, wpts = ref.world(c)
    assert torch.allclose(lms, dep.landmarks, atol=1e-6)
    assert torch.allclose(wpts, dep.waypoints, atol=1e-6)
    st = sl.slam_loop_init(dep.mppi, dep.ekf, pose_xyt=list(dep.start),
                           seed=7, device="cpu")
    gen = torch.Generator().manual_seed(3)
    added = 0
    for t in range(13):
        z = torch.randn((dep.mppi.steps, K, 2), generator=gen) * 2.0
        look = torch.Generator().set_state(st.generator.get_state())
        normals = torch.randn((360,), generator=look)
        plain = _plain_state(st)
        aimed = ref.aim(c, plain, wpts)
        u_new = _plain_solve(c, st.u, z, aimed[0], aimed[1])
        want, tie, rows = ref.act(c, plain, aimed, u_new, normals, lms,
                                  torch.float64)
        st = sl.slam_loop_tick(dep.mppi, dep.ekf, dep.loop, dep.model,
                               dep.waypoints, dep.landmarks, st,
                               meas_fn=dep.meas_fn, noise=z)
        assert not tie and not aimed[5]
        added += sum(j >= plain.count for j in rows)
        assert int(st.ekf.count) == want.count
        assert st.ekf.active.tolist() == want.active
        assert (st.true_pose - want.true_pose).abs().max() < 2e-5
        assert (st.ekf.state[:3] - want.mu[:3]).abs().max() < 2e-5
        assert (st.ekf.state - want.mu).abs().max() < 1e-5
        cov = st.ekf.cov.double()
        assert (cov - want.cov.double()).abs().max() < 1e-4 * cov.abs().max()
        assert int(st.wpt_idx) == want.wpt_idx and bool(st.done) == want.done
    assert added >= 10 and int(st.ekf.count) == added


def test_tracer_phases_in_the_runner(dep):
    """Off, the runner's graphs hold no phase and the tracer records
    nothing; on, each sensing tick records ``slam.sense`` and
    ``ekf.update`` once for all seeds (inside the mapped body), each run
    a ``step.draw`` span and each load a ``step.load`` span."""
    st = _batch(dep, [1, 2])
    profiling.enable(True)
    profiling.enable(False)
    off = _runner(dep, _copy(st))
    off.run()
    assert off._main.graph.phases == []
    assert profiling.records() == {"spans": [], "replays": [], "phases": []}
    profiling.enable(True)
    try:
        on = _runner(dep, _copy(st))
        on.load(_copy(st))
        on.run()
        on.run()
        on.run(tail=True)
        s = profiling.summary()
    finally:
        profiling.enable(False)
    sensing = 2 * CHUNK // 4 + TAIL // 4
    for name in ("slam.sense", "ekf.update"):
        assert s["phases"][name]["count"] == sensing
        assert s["phases"][name]["missed"] == 0
        assert s["phases"][name]["mean_ms"] > 0
    assert s["spans"]["step.draw"]["count"] == 3
    assert s["spans"]["step.load"]["count"] == 1
    assert s["replays"]["timed"] == 3
    # The same bits with the tracer on.
    off.load(_copy(st))
    off.run()
    off.run()
    off.run(tail=True)
    _same_state(on.state, off.state)
    assert not math.isnan(float(on.rows.sum()))
