"""Two-process P-sharded RBPF SLAM: the port's multi-process mapping proof.

Counterpart of ``examples/rbpf_two_process.py``. Where the MPPI proof
(``examples_torch.mppi_two_process``) checks the solve's reductions across
processes, this checks the RBPF's particle exchange: a resample gathers
whole maps across the process boundary (``tpunav_torch.parallel.
pf_slam_step_sharded``). Every rank runs :func:`run_course`: two updates,
then a forced resample — the weights concentrated on particle 3, whose
grid is offset by +1.5 log-odds — so that the third update's exchange
copies particle 3's pose and map to (nearly) every slot, from the rank
that owns it. Both ranks must end with the same bits.

Launcher mode (no ``--process-id``) spawns two ranks and checks them:

    python -m examples_torch.rbpf_two_process --device cpu
    python -m examples_torch.rbpf_two_process --device cuda --backend gloo

Two ranks on one card must use gloo (NCCL refuses two ranks on one
device). Worker mode, one process per host of a multi-host run:

    python -m examples_torch.rbpf_two_process --process-id N \\
        --num-processes 2 --coordinator HOST:PORT --device cuda --out r.npz
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from tpunav_torch.device import DEFAULT_DEVICE

P_TOTAL = 16
STEPS = 2
WINNER = 3           # the particle that takes the weight
OFFSET = 1.5         # its grid's log-odds offset


def run_course(mesh, device) -> dict:
    """The course on ``mesh``; returns the gathered poses, log-weights and
    per-particle grid means (numpy, the same on every rank), the number of
    particles that carry the winner's offset, and this rank's K2, K3 and
    K4 launches over the course."""
    from tpunav_torch.estimation.rbpf import GridConfig, PFConfig
    from tpunav_torch.estimation.rbpf.icp import ICPConfig
    from tpunav_torch.ops import likelihood, map_update
    from tpunav_torch.parallel import pf_init_sharded, pf_slam_step_sharded
    from tpunav_torch.sim.lidar import box_segments, scan_segments

    grid = GridConfig(resolution=0.1, num_beams=90,
                      beam_delta=2 * math.pi / 90)
    cfg = PFConfig(num_particles=P_TOTAL, k_samples=8, grid=grid,
                   sample_range=(1e-4, 1e-3, 1e-3),
                   motion_noise=(1e-4, 1e-3, 1e-3),
                   icp=ICPConfig(max_iter=10))
    counts = (likelihood.LIK_LAUNCHES, map_update.MAP_LAUNCHES,
              map_update.EDT_LAUNCHES)
    segs = box_segments(-1.5, -1.5, 1.5, 1.5, device=device)
    st = pf_init_sharded(cfg, mesh, seed=5, device=device)
    step = pf_slam_step_sharded(cfg, mesh)
    u = torch.tensor([0.0, 0.05], device=device)
    odom_prev = torch.zeros(3, device=device)

    def update(st, i):
        odom = torch.tensor([0.0, 0.05 * (i + 1), 0.0], device=device)
        ranges = scan_segments(odom, segs, num_beams=grid.num_beams,
                               beam_delta=grid.beam_delta,
                               max_range=grid.range_max)
        return step(st, ranges, u, odom, odom_prev), odom

    for i in range(STEPS):
        st, odom_prev = update(st, i)

    # The winner takes ~all the weight, so N_eff ≈ 1 and the next update
    # must resample: its exchange copies the winner's pose and whole map
    # to (nearly) every slot, across the process boundary.
    p_local = P_TOTAL // mesh.size
    rows = torch.arange(mesh.index * p_local, (mesh.index + 1) * p_local,
                        device=device)
    lw = torch.where(rows == WINNER, 0.0, -50.0)
    grids = st.grids + OFFSET * (rows == WINNER).to(st.grids.dtype)[:, None,
                                                                    None]
    st = st._replace(log_weights=lw, grids=grids)
    before = mesh.all_gather(st.grids.mean(dim=(1, 2)))
    st, _ = update(st, STEPS)
    after = mesh.all_gather(st.grids.mean(dim=(1, 2)))
    others = torch.cat([before[:WINNER], before[WINNER + 1:]])
    clones = int((after > others.max() + 0.5 * OFFSET).sum())
    return {"poses": mesh.all_gather(st.poses).cpu().numpy(),
            "log_weights": mesh.all_gather(st.log_weights).cpu().numpy(),
            "grid_means": after.cpu().numpy(), "clones": clones,
            "rank": mesh.index, "shards": mesh.size,
            "launches": [now - then for now, then in zip(
                (likelihood.LIK_LAUNCHES, map_update.MAP_LAUNCHES,
                 map_update.EDT_LAUNCHES), counts)]}


def launcher(device=DEFAULT_DEVICE, backend=None, timeout: float = 600.0):
    """Two spawned ranks run :func:`run_course` on ``device`` (default the
    card; raises without CUDA before they are spawned); raises unless they
    hold the same bits and the resample cloned the winner into at least P−2
    slots. Returns both ranks' results."""
    from examples_torch import launch

    a, b = launch(run_course, (), world=2, device=device, backend=backend,
                  timeout=timeout)
    for key in ("poses", "log_weights", "grid_means"):
        np.testing.assert_array_equal(a[key], b[key])
    if a["clones"] < P_TOTAL - 2:
        raise AssertionError(f"the resample cloned particle {WINNER} into "
                             f"{a['clones']} of {P_TOTAL} slots")
    print(f"2-process RBPF consistent across the forced resample: "
          f"{a['clones']} of {P_TOTAL} particles carry particle {WINNER}'s "
          f"map, on {device}")
    return a, b


def worker(args) -> None:
    from examples_torch import rank_main

    out = rank_main(run_course, (), args.process_id, args.num_processes,
                    args.coordinator, args.device, args.backend)
    if args.out:
        np.savez(args.out, **out)
    print(f"[rank {args.process_id}] {out['clones']} clones", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    args = ap.parse_args()
    if args.process_id is None:
        launcher(args.device, args.backend)
    else:
        worker(args)


if __name__ == "__main__":
    main()
