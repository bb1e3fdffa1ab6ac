"""The port's tracer (``tpunav_torch.runtime.profiling``): the switch and
what it costs off, host spans, the replay and phase timers on the CPU's
host clock, the interval arithmetic and the gap attribution; and on the
card (tests marked ``cuda``, which skip without one) the same bits with
the tracer on, the ICP phase inside its replay and the replay timers
against the profiler's clock.

No JAX here: the card tests compare the port with itself."""

import json
import math

import pytest
import torch

from tpunav_torch import capture
from tpunav_torch.estimation.rbpf import (GridConfig, PFConfig,
                                          best_particle, pf_init)
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.estimation.rbpf.icp import ICPConfig
from tpunav_torch.runtime import profiling
from tpunav_torch.sim import lidar

SMALL = dict(resolution=0.1, num_beams=90, beam_delta=2 * math.pi / 90)
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")   # the profiler's device ops


@pytest.fixture
def tracer():
    profiling.enable(True)
    try:
        yield profiling
    finally:
        profiling.enable(False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracer's device timers")
    return torch.device("cuda", 0)


def _small_filter(p=6, device="cpu"):
    cfg = PFConfig(num_particles=p, k_samples=6,
                   sample_range=(1e-6, 1e-5, 1e-5),
                   motion_noise=(1e-6, 1e-5, 1e-5), grid=GridConfig(**SMALL),
                   icp=ICPConfig(max_iter=10))
    return cfg, pf_init(cfg, seed=1, device=device)


def _scans(cfg, n, device="cpu"):
    """``n`` (scan, u, odometry, previous odometry) of an arc in a box."""
    segs = lidar.box_segments(-1.5, -1.5, 1.5, 1.5, device=device)
    u = torch.tensor([0.02, 0.01], device=device)
    pose = torch.zeros(3, device=device)
    out = []
    for _ in range(n):
        th = pose[0] + u[0]
        nxt = torch.stack([th, pose[1] + u[1] * torch.cos(th),
                           pose[2] + u[1] * torch.sin(th)])
        out.append((lidar.scan_segments(
            nxt, segs, num_beams=cfg.grid.num_beams,
            beam_delta=cfg.grid.beam_delta, max_range=cfg.grid.range_max),
            u, nxt, pose))
        pose = nxt
    return out


def _run_stepper(cfg, st, scans, device="cpu"):
    """A stepper run over ``scans``, the best pose read after each update
    as the RBPF node reads it."""
    stepper = tpf.PFStepper(cfg, st, device)
    for scan in scans:
        best_particle(stepper.step(*scan))[0].tolist()
    return stepper


# ── off ──

def test_off_spans_and_phases_are_one_shared_no_op():
    assert not profiling.ON
    a, b = profiling.span("a"), profiling.span("b", graph=object())
    assert a is b is profiling.phase("pf.icp")
    with a:
        pass
    profiling.enable(True)
    profiling.enable(False)
    with profiling.span("x"):
        pass
    assert profiling.summary()["spans"] == {}


def test_off_a_graph_runs_as_before_and_records_nothing():
    profiling.enable(True)
    profiling.enable(False)      # a fresh, empty record, then off
    calls = []
    g = capture.Graph(lambda: calls.append(1), device="cpu")
    before = capture.read_counts()
    for _ in range(3):
        g()
    assert len(calls) == 3 and g.replays == 0 and g.steps == 3
    assert g.phases == [] and capture.read_counts() == before
    assert profiling.records() == {"spans": [], "replays": [], "phases": []}


def test_stepper_gives_the_same_bits_with_the_tracer_on(tracer):
    cfg, st = _small_filter()
    scans = _scans(cfg, 4)
    tracer.enable(False)
    before = capture.read_counts()
    off = _run_stepper(cfg, pf_init(cfg, seed=1, device="cpu"), scans)
    counts_off = capture.read_counts()
    tracer.enable(True)
    on = _run_stepper(cfg, st, scans)
    assert capture.read_counts() == counts_off == before
    for a, b in zip(off.state[:-1], on.state[:-1]):
        assert torch.equal(a, b)


# ── on ──

def test_spans_carry_their_step_and_parent(tracer):
    g = capture.Graph(lambda: None, device="cpu")
    for _ in range(3):
        with tracer.span("outer", g):
            with tracer.span("inner"):
                pass
            g()
    spans = tracer.records()["spans"]
    outer = [s for s in spans if s[1] == "outer"]
    inner = [s for s in spans if s[1] == "inner"]
    assert [s[4] for s in outer] == [0, 1, 2] == [s[4] for s in inner]
    assert [s[5] for s in outer] == [0, 0, 0]
    assert [s[5] for s in inner] == [s[0] for s in outer]
    for i, o in zip(inner, outer):
        assert o[2] <= i[2] <= i[3] <= o[3]
    s = tracer.summary()["spans"]
    assert s["outer"]["count"] == s["inner"]["count"] == 3


def test_a_span_inside_one_of_its_own_name_is_part_of_it(tracer):
    with tracer.span("step.draw"):
        with tracer.span("step.draw"):
            pass
    assert tracer.summary()["spans"]["step.draw"]["count"] == 1


def test_the_span_ring_is_bounded_and_the_totals_count_every_span(
        tracer, monkeypatch):
    monkeypatch.setattr(profiling, "SPANS", 8)
    tracer.enable(True)
    for _ in range(20):
        with tracer.span("s"):
            pass
    assert len(tracer.records()["spans"]) == 8
    assert tracer.summary()["spans"]["s"]["count"] == 20


def test_spans_under_the_profiler_go_into_the_trace_alone(tracer, tmp_path):
    g = capture.Graph(lambda: torch.ones(4).sum(), device="cpu")
    with tracer.trace(str(tmp_path)):
        with tracer.span("profiled.region", g):
            g()
    with tracer.span("plain.region", g):
        g()
    with open(next(tmp_path.glob("*.pt.trace.json"))) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "profiled.region" in names
    s = tracer.summary()
    assert set(s["spans"]) == {"plain.region"}
    assert s["replays"]["timed"] == 1 and s["replays"]["profiled"] == 1
    assert [r[3] for r in tracer.records()["replays"]] == [True, False]


def test_the_solve_profiler_times_through_a_span(tracer):
    prof = profiling.SolveProfiler(lambda x: x * 2, name="toy")
    for _ in range(4):
        prof(torch.ones(8))
    assert prof.summary()["n"] == 4 and prof.hz() > 0
    assert tracer.summary()["spans"]["toy"]["count"] == 4


def test_cpu_steps_and_their_phases_are_timed_on_the_host(tracer):
    cfg, st = _small_filter()
    stepper = _run_stepper(cfg, st, _scans(cfg, 3))
    rec = tracer.records()
    assert [r[2] for r in rec["replays"]] == [0, 1, 2]
    assert [(p[0], p[1]) for p in rec["phases"]] == [("pf.icp", i)
                                                    for i in range(3)]
    for (t0, t1, _, _), (_, _, ms, off, _) in zip(rec["replays"],
                                                  rec["phases"]):
        assert 0 < ms * 1e6 and 0 <= off * 1e6 and (ms + off) * 1e6 < t1 - t0
    steps = {name: [s[4] for s in rec["spans"] if s[1] == name]
             for name in ("step.draw", "step.load")}
    assert steps == {"step.draw": [0, 1, 2], "step.load": [0, 1, 2]}
    s = tracer.summary()
    assert s["phases"]["pf.icp"]["count"] == 3
    assert s["phases"]["pf.icp"]["missed"] == 0
    assert s["replays"]["timed"] == stepper.graph.steps == 3
    assert 0 <= s["replays"]["idle_pct"] < 100
    # The gaps between the steps are the draws and loads of the next one.
    assert set(s["idle_by_span"]) <= {"step.draw", "step.load",
                                      "host:caller"}


def test_a_phase_outside_a_graph_is_the_no_op(tracer):
    assert tracer.phase("pf.icp") is tracer.phase("other")
    with tracer.phase("pf.icp"):
        pass
    assert tracer.summary()["phases"] == {}


# ── arithmetic ──

@pytest.mark.parametrize("intervals, idle, gaps", [
    ([(0, 10), (20, 30)], 100 / 3, [(10, 20)]),
    ([(0, 10), (5, 15), (30, 40)], 100 * 15 / 40, [(15, 30)]),
    ([(0, 2), (2, 4), (5, 7)], 100 / 7, [(4, 5)]),
    ([(0, 10), (2, 3)], 0.0, [])])
def test_idle_share_of_the_replays_on_one_device(tracer, intervals, idle,
                                                 gaps):
    """The union of the intervals (overlapping, touching or nested) over
    the span from the first start to the last end, and the gaps left."""
    st = profiling._store
    line = st.timeline(torch.device("cpu"))
    for t0, t1 in intervals:
        line.add(st, t0, t1, 0, False)
    assert tracer.summary()["replays"]["idle_pct"] == pytest.approx(idle)
    assert list(st.gaps) == gaps


def test_event_times_map_onto_the_host_clock():
    assert profiling.to_host_ns(1_000_000, 0.0) == 1_000_000
    assert profiling.to_host_ns(1_000_000, 2.5) == 3_500_000
    assert profiling.to_host_ns(1_000_000, 0.0005) == 1_000_500


def test_each_gap_goes_whole_to_the_span_with_most_of_its_own_time():
    spans = [(1, "step.draw", 0, 40, 0, 0),
             (2, "graph.launch", 50, 100, 0, 0),
             (3, "solve", 200, 400, 1, 0),
             (4, "graph.launch", 210, 390, 1, 3)]
    gaps = [(10, 60),      # draw 30 of it, launch 10
            (60, 100),     # launch alone
            (150, 180),    # nothing: the caller
            (205, 395)]    # the child's own time beats its parent's
    out = profiling.attribute(gaps, spans)
    assert out == pytest.approx({"step.draw": 50e-6,
                                 "graph.launch": 40e-6 + 190e-6,
                                 "host:caller": 30e-6})


def test_summary_idle_and_gaps_from_replays_on_the_host(tracer):
    st = profiling._store
    line = st.timeline(torch.device("cpu"))
    for t0, t1 in [(0, 100), (150, 250), (250, 300)]:
        line.add(st, t0, t1, 0, False)
    line.add(st, 400, 500, 0, True)          # profiled: ends the run
    line.add(st, 900, 1000, 0, False)
    s = tracer.summary()["replays"]
    assert s["timed"] == 4 and s["profiled"] == 1
    assert s["window_ms"] == pytest.approx(400e-6)
    assert s["idle_pct"] == pytest.approx(100 * 50 / 400)
    assert list(st.gaps) == [(100, 150)]


# ── on the card ──

def _course(device, k, chunk, ticks):
    from tpunav_torch.control.mppi import MPPIConfig
    from tpunav_torch.control.waypoint_loop import (CourseConfig,
                                                    course_init,
                                                    run_course_chunked)
    from tpunav_torch.models.cart import CartParams

    cfg = MPPIConfig(rollouts=k)
    course = CourseConfig(use_fused=True, max_ticks=ticks)
    wpts = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0]],
                        device=device)
    st = course_init(cfg, torch.zeros(3), device=device)
    return run_course_chunked(cfg, course, CartParams(0.033, 0.16), wpts,
                              st, chunk=chunk)


def _explore(device, scans):
    from examples_torch import rbpf_explore_demo as demo

    pf_cfg, mppi_cfg = demo.configs()
    g = demo.ScanGraph(pf_cfg, mppi_cfg, demo.init_state(
        pf_cfg, mppi_cfg, device=device), device)
    for _ in range(scans):
        g.step()
    return g


def _rbpf(device, updates):
    from examples_torch import rbpf_explore_demo as demo

    cfg = demo.configs()[0]
    scans = _scans(cfg, updates, device)
    return _run_stepper(cfg, pf_init(cfg, seed=1, device=device), scans,
                        device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["course", "tick", "rbpf", "explore"])
def test_the_tracer_changes_no_bit_on_the_card(card, case):
    def run():
        if case == "course":
            return list(_course(card, 4096, 240, 720)[:2])
        if case == "tick":
            return list(_course(card, 49152, 1, 30)[:2])
        if case == "rbpf":
            return list(_rbpf(card, 12).state[:-1])
        snap = _explore(card, 8).snapshot()
        return list(snap.pf[:-1]) + [t for t in snap[1:]
                                     if isinstance(t, torch.Tensor)]

    profiling.enable(False)
    before = capture.read_counts()
    off = run()
    deltas = {k: v - before[k] for k, v in capture.read_counts().items()}
    profiling.enable(True)
    try:
        before = capture.read_counts()
        on = run()
        torch.cuda.synchronize()
        s = profiling.summary()
    finally:
        profiling.enable(False)
    assert {k: v - before[k] for k, v in
            capture.read_counts().items()} == deltas
    for a, b in zip(off, on, strict=True):
        assert torch.equal(a, b)
    assert s["replays"]["timed"] > 0


@pytest.mark.cuda
def test_the_icp_phase_lies_inside_its_replay_on_the_card(card):
    profiling.enable(True)
    try:
        stepper = _rbpf(card, 20)
        torch.cuda.synchronize()
        rec = profiling.records()
        s = profiling.summary()
    finally:
        profiling.enable(False)
    replays = {r[2]: r for r in rec["replays"]}
    phases = [p for p in rec["phases"] if p[0] == "pf.icp"]
    assert phases
    for _, step, ms, off, _ in phases:
        t0, t1 = replays[step][:2]
        assert 0 < ms * 1e6 and 0 < off * 1e6 and (ms + off) * 1e6 < t1 - t0
    r = s["replays"]
    assert r["timed"] + r["in_flight"] == stepper.graph.replays


@pytest.mark.cuda
def test_replay_timers_agree_with_the_profilers_clock(card, tmp_path):
    """Ten replays timed by the tracer and by the profiler at once. Aligned
    at their median end, each replay's end event lies where the profiler
    puts its last device operation, and its start event before the first,
    within 5% of the replay; the interval covers the operations' span."""
    from torch.profiler import ProfilerActivity, profile

    from examples_torch import rbpf_explore_demo as demo

    cfg = demo.configs()[0]
    scans = _scans(cfg, 12, card)
    profiling.enable(True)
    try:
        stepper = _run_stepper(cfg, pf_init(cfg, seed=1, device=card),
                               scans[:2], card)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for scan in scans[2:]:
                best_particle(stepper.step(*scan))[0].tolist()
        rec = profiling.records()
    finally:
        profiling.enable(False)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = sorted(e["args"]["correlation"] for e in events
                      if e.get("name") == "cudaGraphLaunch")
    ops = {}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE and c in launches:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            lo, hi = ops.get(c, (a, b))
            ops[c] = (min(lo, a), max(hi, b))
    timed = [(t0 * 1e-3, t1 * 1e-3) for t0, t1, _, p in rec["replays"] if p]
    assert len(timed) == len(launches) == 10
    pairs = [(t, ops[c]) for t, c in zip(timed, launches)]
    shifts = sorted(b - t1 for (_, t1), (_, b) in pairs)
    shift = shifts[len(shifts) // 2]
    for (t0, t1), (a, b) in pairs:
        tol = 0.05 * (t1 - t0)
        assert abs(t1 + shift - b) < tol
        assert t0 + shift < a + tol
        assert t1 - t0 > 0.98 * (b - a)
