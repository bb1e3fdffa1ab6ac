"""Stage-by-stage cost of the RBPF SLAM update, and of the exploration
loop's scan interval.

Counterpart of ``examples/profile_rbpf_stages.py``, which jits each stage.
:func:`stage_times` times each stage of ``pf_slam_step`` at BASELINE
config 5 (P=500, k=50, 360 beams, 80×80 maps) as its own CUDA graph
(``capture.Graph``) on static inputs: the scan matcher, the likelihood
sweep (kernel K2), the pose likelihood, the Gaussian fit and draw, the map
update (kernel K3), the resample gather and the whole step through
``PFStepper``. :func:`profile_closed_loop` splits
``examples_torch.rbpf_explore_demo``'s scan interval into three graphs
chained per scan (:class:`ChainedStages`: the control chunk of 6 K1
solves, the lidar raycast, and ``PFStepper``'s update) with CUDA-event
marks between the replays, on the buffers of the demo's ``ScanGraph``, so
the stages run on the loop's own inputs and the chained scans give the
demo's bits; beside them the demo's one replay per scan. The chained sum
less the one replay is ``tpunav``'s "host glue + chain serialization"
line (``examples/profile_rbpf_stages.py:200-202``): what chaining three
programs costs against one. ``eager=True`` gives both splits of the eager
forms instead (``build(..., eager=True)``'s interval, split by marks
inside the chained loop). The interval also gives its kernel launches
(``torch.profiler``) and host syncs (torch's sync debug mode) per scan.

    python -m examples_torch.profile_rbpf_stages [--closed-loop] [--eager]
        [--device cpu]
"""

from __future__ import annotations

import torch

from examples_torch import (Marks, device_parser, launches_per_call,
                            synchronize, syncs_per_call)
from tpunav_torch import capture
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.rbpf import pf_init, pf_slam_step
from tpunav_torch.estimation.rbpf import particle_filter as pfm
from tpunav_torch.estimation.rbpf.icp import icp_match, scan_to_points
from tpunav_torch.ops.likelihood import likelihood_field_batch
from tpunav_torch.ops.map_update import map_update_batch
from tpunav_torch.sim.lidar import box_segments, scan_segments


def time_ms(fn, reps: int, device, warmup: int = 1) -> float:
    """ms per call of ``fn`` over ``reps`` calls after ``warmup`` calls:
    CUDA events on the card, the host's clock on the CPU."""
    for _ in range(warmup):
        fn()
    marks = Marks(device)
    a = marks.mark()
    for _ in range(reps):
        fn()
    b = marks.mark()
    synchronize(device)
    return marks.ms(a, b) / reps


def stage_times(num_particles=500, reps=10, device=DEFAULT_DEVICE,
                eager=False) -> dict:
    """ms per call of each stage of ``pf_slam_step`` at config 5, on a
    filter that has mapped two scans of the box course: each stage one
    ``capture.Graph`` replay on static inputs (the whole step a
    ``PFStepper`` replay), or with ``eager`` its operations one by one."""
    from examples_torch.rbpf_explore_demo import configs

    device = resolve(device)
    cfg = configs(num_particles)[0]
    grid, p, k = cfg.grid, cfg.num_particles, cfg.k_samples
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, device=device)
    u = torch.tensor([0.03, 0.02]).to(device)
    pose = torch.tensor([0.06, 0.04, 0.01]).to(device)
    prev = torch.zeros(3, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    scan = scan_segments(pose, segs, num_beams=grid.num_beams,
                         max_range=grid.range_max, generator=gen,
                         noise_std=0.002)

    def step(s):
        return pf_slam_step(cfg, s, scan, u, pose, prev)

    st = step(step(pf_init(cfg, seed=0, device=device)))   # maps warm
    samples = st.poses[:, None, :] + 0.003 * torch.randn(
        (p, k + 1, 3), generator=gen, device=device)
    normals = torch.randn((p, 3), generator=gen, device=device)
    logp = likelihood_field_batch(grid, st.dists, scan, samples)
    pts = [scan_to_points(s, grid.range_min, grid.range_max, grid.beam_min,
                          grid.beam_delta) for s in (scan, st.prev_scan)]
    guess = torch.zeros(3, device=device)
    whole = "whole pf_slam_step"
    stages = {
        f"icp ({cfg.icp.max_iter} iterations)":
            lambda: icp_match(cfg.icp, *pts[0], *pts[1], guess),
        f"likelihood K2 (P={p}, k+1={k + 1})":
            lambda: likelihood_field_batch(grid, st.dists, scan, samples),
        "pose likelihood P×k":
            lambda: pfm.pose_likelihood_odom(cfg, samples[:, :k],
                                             st.poses[:, None, :], pose,
                                             prev),
        "gaussian fit + draw":
            lambda: pfm._gaussian_from_samples(cfg, samples[:, :k],
                                               logp[:, :k], st.poses, pose,
                                               prev, normals),
        "map update K3":
            lambda: map_update_batch(grid, st.grids, scan, st.poses),
        "resample gather":
            lambda: pfm._low_variance_resample(cfg, st, normals[0, 0]),
    }
    if eager:
        stages[whole] = lambda: step(st)
        return {name: time_ms(fn, reps, device)
                for name, fn in stages.items()}
    # Each stage's outputs are its graph's own; the inputs stay static.
    out = {name: time_ms(capture.Graph(fn, device), reps, device, warmup=2)
           for name, fn in stages.items()}
    stepper = pfm.PFStepper(cfg, st, device)
    stepper.draw()
    capture.load(stepper.inputs, (scan, u, pose, prev))
    out[f"{whole} (PFStepper)"] = time_ms(stepper.graph, reps, device,
                                          warmup=2)
    return out


# The scan interval's stages, in the order rbpf_explore_demo runs them.
STAGES = ("control chunk (6 K1 solves)", "lidar sense (raycast)",
          "SLAM update (pf_slam_step: K2, K3)")


class ChainedStages:
    """The exploration loop's scan interval as three ``capture.Graph``
    steps chained per scan — the control chunk, the raycast, and
    ``PFStepper``'s update with the five-metric sample — on the buffers
    and draws of :attr:`scan_graph`, an ``rbpf_explore_demo.ScanGraph``
    built from ``st`` on ``device`` (default the card; raises without
    CUDA). A scan through the three gives the bits of one
    ``scan_graph.step()``, and the two may alternate."""

    def __init__(self, pf_cfg, mppi_cfg, st, device=DEFAULT_DEVICE):
        from examples_torch import rbpf_explore_demo as ex

        graph = self.scan_graph = ex.ScanGraph(pf_cfg, mppi_cfg, st, device)
        dev = graph.graph.device
        world = ex._world(dev)
        carry, tick, noise = graph.carry, graph.tick_dev, graph.scan_noise
        state, update = graph.stepper.state, graph.stepper.update
        scan_in, u_in, cur_in, prev_in = graph.stepper.inputs
        sample = graph.sample
        prev = torch.zeros_like(carry[1])

        def control():
            prev.copy_(carry[1])
            capture.load(carry, ex._control(mppi_cfg, world, *carry, tick))
            tick.add_(1)

        def sense():
            scan_in.copy_(ex._sense(pf_cfg.grid, world, carry[0],
                                    noise=noise))

        def slam():
            u_in.copy_(ex.body_twist(carry[1], prev))
            cur_in.copy_(carry[1])
            prev_in.copy_(prev)
            update()
            sample.copy_(ex._metrics(state, carry[0], carry[1]))

        self.graphs = [capture.Graph(f, dev) for f in (control, sense, slam)]

    def step(self, mark=lambda: None) -> torch.Tensor:
        """One scan: the draws, then the three replays with ``mark()``
        before the first and after each; returns the static sample."""
        self.scan_graph.draw()
        mark()
        for g in self.graphs:
            g()
            mark()
        self.scan_graph.tick += 1
        return self.scan_graph.sample


def profile_closed_loop(num_particles=500, reps=10, rollouts=2048,
                        device=DEFAULT_DEVICE, eager=False) -> dict:
    """ms per scan of the exploration loop's stages — the 6-solve control
    chunk, the lidar raycast and the SLAM update — from marks between
    :class:`ChainedStages`' replays over ``reps`` scans after two warm-up
    scans, their sum, and then ``reps`` scans of the demo's one
    ``ScanGraph`` replay on the same buffers; the sum less the one replay
    is what chaining costs. With ``eager`` the marks split ``reps``
    chained scans of the eager interval instead (they add up to it). On
    the card also launches and host syncs per scan. Returns {name:
    value}."""
    from examples_torch import rbpf_explore_demo as ex

    device = resolve(device)
    if eager:
        return _eager_closed_loop(num_particles, reps, rollouts, device)
    pf_cfg, mppi_cfg = ex.configs(num_particles, rollouts)
    chained = ChainedStages(pf_cfg, mppi_cfg, ex.init_state(
        pf_cfg, mppi_cfg, device=device), device)
    graph = chained.scan_graph
    chained.step()                       # the warm-ups
    chained.step()                       # the captures
    graph.step()
    graph.step()
    marks = Marks(device)
    for _ in range(reps):
        chained.step(marks.mark)
    one = []
    for _ in range(reps):
        graph.draw()
        one.append(marks.mark())
        graph.graph()
        graph.tick += 1
        marks.mark()
    synchronize(device)
    n = len(STAGES) + 1
    out = {name: sum(marks.ms(n * s + i, n * s + i + 1)
                     for s in range(reps)) / reps
           for i, name in enumerate(STAGES)}
    out["stages chained (sum)"] = sum(out[name] for name in STAGES)
    out["ScanGraph scan (one replay)"] = sum(
        marks.ms(i, i + 1) for i in one) / reps
    out["host glue + chain serialization"] = (
        out["stages chained (sum)"] - out["ScanGraph scan (one replay)"])
    if device.type == "cuda":
        out.update(_per_scan(lambda: [chained.step() for _ in range(reps)],
                             reps))
    return out


def _eager_closed_loop(num_particles, reps, rollouts, device) -> dict:
    """:func:`profile_closed_loop`'s eager form: ``reps`` chained scans of
    ``build(..., eager=True)``'s interval, split by its marks."""
    from examples_torch import rbpf_explore_demo as ex

    pf_cfg, mppi_cfg, run_chunk = ex.build(num_particles, reps, rollouts,
                                           device, eager=True)
    st = run_chunk(ex.init_state(pf_cfg, mppi_cfg, device=device))
    marks = Marks(device)
    st = run_chunk(st, marks=marks)
    synchronize(device)
    n = len(STAGES)
    out = {name: sum(marks.ms(n * s + i, n * s + i + 1)
                     for s in range(reps)) / reps
           for i, name in enumerate(STAGES)}
    out["whole scan interval (chained)"] = marks.ms(0, n * reps) / reps
    if device.type == "cuda":
        box = [st]

        def interval():
            box[0] = run_chunk(box[0])

        out.update(_per_scan(interval, reps))
    return out


def _per_scan(interval, reps: int) -> dict:
    """Device kernels launched and host syncs per scan over one call of
    ``interval`` each (``reps`` scans a call)."""
    return {"launches per scan": launches_per_call(interval, 1) / reps,
            "host syncs per scan": syncs_per_call(interval, 1) / reps}


def main():
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--closed-loop", action="store_true",
                    help="the exploration loop's per-scan budget")
    ap.add_argument("--eager", action="store_true",
                    help="the eager forms' split, not the graphs'")
    args = ap.parse_args()
    res = (profile_closed_loop(device=args.device, eager=args.eager)
           if args.closed_loop
           else stage_times(device=args.device, eager=args.eager))
    print(f"ms per {'scan' if args.closed_loop else 'call'} on {args.device}"
          f"{' (launches and syncs: counts per scan)' if args.closed_loop
             else ''}")
    for name, v in res.items():
        print(f"{name:48s} {v:10.2f}", flush=True)


if __name__ == "__main__":
    main()
