"""``capture.Draws``, the one seam of a replayed step's eager draws: each
runner that draws, stepped through it on the CPU (its graph's body on the
same static tensors), against its eager path, bit for bit, the
generators' states included. Where a run stops inside a chunk, the runner
rewinds the chunk's draws to its live ticks, which these cases reach."""

import math

import pytest
import torch

from examples_torch import rbpf_explore_demo as explore
from examples_torch import slam_mppi_closed_loop_demo as c3
from tpunav_torch import capture
from tpunav_torch.control import mppi
from tpunav_torch.control import slam_loop as sl
from tpunav_torch.control.waypoint_loop import (CourseConfig, course_init,
                                                course_tick, run_course,
                                                run_course_chunked)
from tpunav_torch.estimation.rbpf import GridConfig
from tpunav_torch.estimation.rbpf import particle_filter as tpf
from tpunav_torch.estimation.rbpf.icp import ICPConfig
from tpunav_torch.models.cart import CartParams
from tpunav_torch.sim import lidar

torch.set_num_threads(1)

MODEL = CartParams(0.033, 0.160)
CFG = mppi.MPPIConfig(horizon=0.2, dt=0.02, rollouts=16, ul_var=4.0,
                      ur_var=4.0)
WPTS = torch.tensor([[0.08, 0.0, 0.0], [0.08, 0.06, 1.57]])
COURSE_FIELDS = ("pose", "u", "wpt_idx", "visits", "ticks", "done",
                 "wheel_vel")
SLAM_FIELDS = ("true_pose", "odom", "u", "wpt_idx", "visits", "ticks",
               "done")


def _fields(got, want, names):
    return [(f, getattr(got, f), getattr(want, f)) for f in names]


def _course_start():
    return course_init(CFG, torch.zeros(3), seed=2, device="cpu")


def _course_eager(course, ticks):
    st = _course_start()
    for _ in range(ticks):
        st = course_tick(CFG, course, MODEL, WPTS, st)
    return st


def _course():
    """``run_course`` on the plain backend, chunks of 3 held ticks to
    ``max_ticks`` 7: the last chunk has one live tick, so its draws are
    rewound to that tick's."""
    course = CourseConfig(goal_thresh=0.03, max_ticks=7)
    got = run_course(CFG, course, MODEL, WPTS, _course_start(), chunk=3)
    want = _course_eager(course, 7)
    return _fields(got, want, COURSE_FIELDS + ("generator",))


def _course_chunked():
    """``run_course_chunked`` on the plain backend: two chunks of 3
    ticks, each drawing all of its ticks' perturbations."""
    course = CourseConfig(goal_thresh=0.03, max_ticks=6)
    got = run_course_chunked(CFG, course, MODEL, WPTS, _course_start(),
                             chunk=3)
    want = _course_eager(course, 6)
    return _fields(got, want, COURSE_FIELDS + ("generator",))


def _c3(use_fused):
    m, e, loop = c3.configs(True, 12, use_fused=use_fused, rollouts=16)
    wpts = torch.tensor([[0.12, 0.0, 0.0], [0.12, 0.1, 1.57]])
    lms = torch.as_tensor(c3.block_world())
    return m, e, loop, wpts, lms


def _slam_loop():
    """``run_slam_loop`` on the plain backend from 2 ticks in: eager ticks
    to the sensing tick 6, then chunks of 12 held ticks, the last with 2
    live ticks to ``max_ticks`` 20 (each tick's perturbations, the sensing
    ticks' normals, rewound to the live ticks')."""
    m, e, loop, wpts, lms = _c3(False)

    def eager(ticks):
        st = sl.slam_loop_init(m, e, seed=1, device="cpu")
        for _ in range(ticks):
            st = sl.slam_loop_tick(m, e, loop, c3.MODEL, wpts, lms, st)
        return st

    got = sl.run_slam_loop(m, e, loop, c3.MODEL, wpts, lms, eager(2),
                           max_ticks=20, chunk=12)
    want = eager(20)
    assert got.host_ticks == want.host_ticks == 20
    return (_fields(got, want, SLAM_FIELDS + ("generator",)) +
            list(zip(want.ekf._fields, got.ekf, want.ekf)))


def _slam_batch():
    """``run_slam_course`` over a seed batch of 2 (the fused backend): 30
    ticks as two 12-tick chunks and the 6-tick tail, each seed's sensor
    normals from its own generator; against each seed's eager ticks."""
    m, e, loop, wpts, lms = _c3(True)
    seeds = (3, 4)
    got, _ = sl.run_slam_course(m, e, loop, c3.MODEL, wpts, lms,
                                sl.slam_batch_init(m, e, seeds,
                                                   device="cpu"),
                                ticks=30, chunk=12)
    out = []
    for i, seed in enumerate(seeds):
        want = sl.slam_loop_init(m, e, seed=seed, device="cpu")
        for _ in range(30):
            want = sl.slam_loop_tick(m, e, loop, c3.MODEL, wpts, lms, want)
        one = sl.seed_state(got, i)
        out += _fields(one, want, SLAM_FIELDS + ("generator",))
        out += list(zip(want.ekf._fields, one.ekf, want.ekf))
    return out


def _pf_stepper():
    """Three ``PFStepper`` updates against ``pf_slam_step``'s: the four
    normals of ``draw_noise`` drawn into the static tensors."""
    cfg = tpf.PFConfig(num_particles=4, k_samples=6,
                       sample_range=(1e-6, 1e-5, 1e-5),
                       motion_noise=(1e-6, 1e-5, 1e-5),
                       grid=GridConfig(resolution=0.1, num_beams=90,
                                       beam_delta=2 * math.pi / 90),
                       icp=ICPConfig(max_iter=8))
    segs = lidar.box_segments(-1.5, -1.5, 1.5, 1.5, device="cpu")
    u = torch.tensor([0.02, 0.01])
    want = tpf.pf_init(cfg, seed=1, device="cpu")
    stepper = tpf.PFStepper(cfg, tpf.pf_init(cfg, seed=1, device="cpu"),
                            device="cpu")
    prev = torch.zeros(3)
    for i in range(3):
        pose = prev + torch.tensor([0.02, 0.01, 0.0])
        scan = lidar.scan_segments(pose, segs, num_beams=90,
                                   beam_delta=2 * math.pi / 90,
                                   max_range=cfg.grid.range_max,
                                   generator=torch.Generator().manual_seed(i),
                                   noise_std=0.005)
        want = tpf.pf_slam_step(cfg, want, scan, u, pose, prev)
        got = stepper.step(scan, u, pose, prev)
        prev = pose
    return list(zip(tpf.PFState._fields, got, want))


def _controller():
    """Three ``MPPIController`` solves against ``mppi_solve``'s, their
    perturbations drawn into the static tensor."""
    ctl = mppi.MPPIController(CFG, MODEL, seed=4, device="cpu")
    ctl.set_waypoint(WPTS[0])
    gen = torch.Generator().manual_seed(4)
    u = mppi.init_controls(CFG, device="cpu")
    pose = torch.zeros(3)
    out = []
    for i in range(3):
        got = ctl.new_controls(pose)
        want, u = mppi.mppi_solve(CFG, MODEL, u, gen, pose, WPTS[0])
        out.append((f"cmd{i}", got, want))
        pose = pose + 0.01
    return out + [("u", ctl.u, u), ("generator", ctl.generator, gen)]


def _explore():
    """Three scans of the exploration demo's ``ScanGraph`` against the
    eager interval: the lidar's normals, then the filter's, from their two
    generators."""
    runs = []
    for eager in (True, False):
        pf_cfg, mppi_cfg, run_chunk = explore.build(8, 3, 64, "cpu",
                                                    eager=eager)
        runs.append(run_chunk(explore.init_state(pf_cfg, mppi_cfg,
                                                 device="cpu")))
    want, got = runs
    return (_fields(got, want, ("true_pose", "odom_pose", "u", "wheel_vel",
                                "wpt_idx", "scan_gen")) +
            list(zip(tpf.PFState._fields, got.pf, want.pf)))


@pytest.mark.parametrize("case", [_course, _course_chunked, _slam_loop,
                                  _slam_batch, _pf_stepper, _controller,
                                  _explore], ids=lambda f: f.__name__[1:])
def test_a_step_through_the_draws_is_the_eager_step(case):
    """Every tensor and every generator's state of the runner after its
    steps equal the eager path's, bit for bit."""
    for name, got, want in case():
        if isinstance(want, torch.Generator):
            got, want = got.get_state(), want.get_state()
        assert torch.equal(got, want), name


def test_draws_fill_slots_in_order_and_rewind_to_the_first_n():
    """Slots fill in order, each seed's rows from its own generator; a
    rewind sets every generator back and draws the first slots again;
    injected noise is loaded in place and leaves nothing to rewind."""
    gens = [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
    a, b = torch.empty(4), torch.empty(2, 3)
    draws = capture.Draws(inject=(a, b)).add(a, gens[0]).add(
        b, (gens[1], gens[2]))
    draws()
    ref = [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
    assert torch.equal(a, torch.randn(4, generator=ref[0]))
    for row, g in zip(b, ref[1:]):
        assert torch.equal(row, torch.randn(3, generator=g))
    draws.rewind(1)
    ref = [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
    torch.randn(4, generator=ref[0])
    for g, want in zip(gens, ref):
        assert torch.equal(g.get_state(), want.get_state())
    draws((torch.ones(4), torch.zeros(2, 3)))
    assert torch.equal(a, torch.ones(4)) and not b.any()
    before = [g.get_state() for g in gens]
    draws.rewind(2)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(gens, before))
