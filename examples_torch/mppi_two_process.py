"""Two-process K-sharded MPPI: the port's multi-process deployment proof.

Counterpart of ``examples/mppi_two_process.py`` (the reference's
two-machine launch, nuturtle_robot/launch/basic_remote.launch:1-40). Every
rank runs :func:`run_course`: 20 chained fused solves at K=4,096, N=50,
each rank rolling out K/S through kernel K1's partials and the softmax
combined across the ranks (``tpunav_torch.parallel.
mppi_solve_fused_sharded``: one MIN and one SUM all-reduce per solve).
The controls are the same on every rank.

Launcher mode (no ``--process-id``) spawns two ranks, checks that they
hold the same bits, and prints each rank's solves/s:

    python -m examples_torch.mppi_two_process --device cpu
    python -m examples_torch.mppi_two_process --device cuda --backend gloo

Two ranks on one card must use gloo (NCCL refuses two ranks on one
device); they share the card, so their rates are no measure of scaling.

Worker mode, one process per host of a multi-host run:

    python -m examples_torch.mppi_two_process --process-id N \\
        --num-processes 2 --coordinator HOST:PORT --device cuda --out r.npz

:func:`run_course` draws in-kernel Philox per shard seed; with
``noise="global"`` it draws the global (N, K, 2) perturbations from a
generator every rank seeds alike and gives each rank its K/S columns, so a
run equals the one-rank run of the same course up to the order of the
softmax sums.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tpunav_torch.device import DEFAULT_DEVICE

ROLLOUTS = 4096
SOLVES = 20
SEED = 7


def run_course(mesh, device, rollouts: int = ROLLOUTS, solves: int = SOLVES,
               noise: str = "kernel") -> dict:
    """``solves`` chained sharded solves from the origin toward (1, 1) on
    ``mesh``; returns this rank's last command and controls (numpy), its
    solves/s after a warm-up solve, and its K1 launches (all, and those in
    obstacle mode)."""
    from tpunav_torch.control.mppi import MPPIConfig, init_controls
    from tpunav_torch.models.cart import CartParams
    from tpunav_torch.ops import fused_mppi
    from tpunav_torch.parallel import mppi_solve_fused_sharded

    cfg = MPPIConfig(horizon=0.5, dt=0.01, rollouts=rollouts)
    solve = mppi_solve_fused_sharded(cfg, CartParams(0.033, 0.160), mesh)
    pose = torch.tensor([0.1, -0.2, 0.3], device=device)
    xd = torch.tensor([1.0, 1.0, 0.0], device=device)
    k_local = rollouts // mesh.size
    cols = slice(mesh.index * k_local, (mesh.index + 1) * k_local)
    sig = torch.tensor([cfg.ul_var, cfg.ur_var]).sqrt().to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def draw():
        if noise == "kernel":
            return None
        z = torch.randn((cfg.steps, rollouts, 2), generator=gen,
                        device=device) * sig
        return z[:, cols].contiguous()

    solve(init_controls(cfg, device=device), SEED, pose, xd, draw())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    launches = fused_mppi.KERNEL_LAUNCHES
    obstacle = fused_mppi.OBSTACLE_LAUNCHES
    t0 = time.perf_counter()
    u = init_controls(cfg, device=device)
    for i in range(solves):
        cmd, u = solve(u, SEED + i, pose, xd, draw())
    cmd, u = cmd.cpu().numpy(), u.cpu().numpy()
    return {"cmd": cmd, "u": u, "rank": mesh.index, "shards": mesh.size,
            "solves_per_sec": solves / (time.perf_counter() - t0),
            "k1_launches": fused_mppi.KERNEL_LAUNCHES - launches,
            "k1_obstacle_launches": fused_mppi.OBSTACLE_LAUNCHES - obstacle}


def launcher(device=DEFAULT_DEVICE, backend=None, noise: str = "kernel",
             rollouts: int = ROLLOUTS, solves: int = SOLVES,
             timeout: float = 600.0):
    """Two spawned ranks run :func:`run_course` on ``device`` (default the
    card; raises without CUDA before they are spawned); raises unless they
    hold the same bits. Returns both ranks' results."""
    from examples_torch import launch

    a, b = launch(run_course, (rollouts, solves, noise), world=2,
                  device=device, backend=backend, timeout=timeout)
    np.testing.assert_array_equal(a["cmd"], b["cmd"])
    np.testing.assert_array_equal(a["u"], b["u"])
    print(f"2-process MPPI consistent: cmd={a['cmd']} "
          f"({a['solves_per_sec']:.1f} / {b['solves_per_sec']:.1f} solves/s "
          f"per rank at K={rollouts}, on {device}; ranks that share a device "
          "give no scaling number)")
    return a, b


def worker(args) -> None:
    from examples_torch import rank_main

    out = rank_main(run_course, (),
                    args.process_id, args.num_processes, args.coordinator,
                    args.device, args.backend)
    if args.out:
        np.savez(args.out, **out)
    print(f"[rank {args.process_id}] {out['solves_per_sec']:.1f} solves/s",
          flush=True)


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
