"""Stage-by-stage cost of the RBPF SLAM update, and of the exploration
loop's scan interval.

Counterpart of ``examples/profile_rbpf_stages.py``. :func:`stage_times`
times each stage of ``pf_slam_step`` at BASELINE config 5 (P=500, k=50,
360 beams, 80×80 maps): the scan matcher, the likelihood sweep (kernel
K2), the pose likelihood, the Gaussian fit and draw, the map update
(kernel K3), the resample gather and the whole step.
:func:`profile_closed_loop` splits ``examples_torch.rbpf_explore_demo``'s
eager scan interval (``build(..., eager=True)``; the demo itself replays
the interval as one CUDA graph, which marks cannot split) into the
control chunk (6 K1 solves), the lidar raycast and the SLAM update, from
CUDA-event marks placed between them inside the chained loop itself, so the stages run on the loop's inputs and add up to
the whole interval; :func:`stage_times` times each stage alone with CUDA
events over repeated calls (ms per call). The interval also gives its
kernel launches (``torch.profiler``) and host syncs (torch's sync debug
mode) per scan: the host issues the launches one by one, so the
interval's time follows its launch count more than its device time.

    python -m examples_torch.profile_rbpf_stages [--closed-loop]
        [--device cpu]
"""

from __future__ import annotations

import torch

from examples_torch import (Marks, device_parser, launches_per_call,
                            synchronize, syncs_per_call)
from tpunav_torch.device import DEFAULT_DEVICE, resolve
from tpunav_torch.estimation.rbpf import pf_init, pf_slam_step
from tpunav_torch.estimation.rbpf import particle_filter as pfm
from tpunav_torch.estimation.rbpf.icp import icp_match, scan_to_points
from tpunav_torch.ops.likelihood import likelihood_field_batch
from tpunav_torch.ops.map_update import map_update_batch
from tpunav_torch.sim.lidar import box_segments, scan_segments


def time_ms(fn, reps: int, device) -> float:
    """ms per call of ``fn`` over ``reps`` calls after one warm-up call:
    CUDA events on the card, the host's clock on the CPU."""
    fn()
    marks = Marks(device)
    a = marks.mark()
    for _ in range(reps):
        fn()
    b = marks.mark()
    synchronize(device)
    return marks.ms(a, b) / reps


def stage_times(num_particles=500, reps=10, device=DEFAULT_DEVICE) -> dict:
    """ms per call of each stage of ``pf_slam_step`` at config 5, on a
    filter that has mapped two scans of the box course."""
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
        "whole pf_slam_step": lambda: step(st),
    }
    return {name: time_ms(fn, reps, device) for name, fn in stages.items()}


# The scan interval's stages, in the order rbpf_explore_demo runs them.
STAGES = ("control chunk (6 K1 solves)", "lidar sense (raycast)",
          "SLAM update (pf_slam_step: K2, K3)")


def profile_closed_loop(num_particles=500, reps=10, rollouts=2048,
                        device=DEFAULT_DEVICE) -> dict:
    """ms per scan of the exploration loop's stages — the 6-solve control
    chunk, the lidar raycast and the SLAM update (``pf_slam_step`` with
    the odometry twist) — and of the whole interval, from marks inside
    ``reps`` chained scans of ``run_chunk`` after a warm-up chunk: each
    stage runs on the loop's own inputs, and the stages add up to the
    whole. On the card also the interval's launches and host syncs per
    scan, over one more chunk each. Returns {stage: value}."""
    from examples_torch import rbpf_explore_demo as ex

    device = resolve(device)
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

        out["launches per scan"] = launches_per_call(interval, 1) / reps
        out["host syncs per scan"] = syncs_per_call(interval, 1) / reps
    return out


def main():
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--closed-loop", action="store_true",
                    help="the exploration loop's per-scan budget")
    args = ap.parse_args()
    res = (profile_closed_loop(device=args.device) if args.closed_loop
           else stage_times(device=args.device))
    print(f"ms per {'scan' if args.closed_loop else 'call'} on {args.device}"
          f"{' (launches and syncs: counts per scan)' if args.closed_loop
             else ''}")
    for name, v in res.items():
        print(f"{name:48s} {v:10.2f}", flush=True)


if __name__ == "__main__":
    main()
