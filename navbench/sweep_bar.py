"""The end errors of a sweep cell's whole sweeps: the readings that its
``sweep_bar_m`` is set from. The benchmark's own runs never run this.

For each run seed, the first ``--sweeps`` sweeps that the cell's driver
would load (their seeds and K1 seed bases drawn as
``drivers/dense_sweep.py`` draws them) run to their ends at once, as one
seed batch through the program's ``run_slam_course`` (each seed's bits are
its own, whatever the batch), and each seed's filter and odometry position
errors against the plant's at the end are read.

    python3 -m navbench.sweep_bar --workload ekf_sweep_b20 --seeds 1,2,3,4
        --sweeps 13 [--out <JSON-lines file>]

One JSON line per run seed: {"seed", "sweeps", "seconds", "slam_m" and
"odom_m": each sweep's worst seed}.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import harness
from .drivers.dense_sweep import draws


def end_errors(cell: dict, seed: int, sweeps: int, device="cuda",
               sizes=None) -> dict:
    """Each of the first ``sweeps`` sweeps' worst filter and odometry
    position errors at its end, in metres."""
    from tpunav_torch.control.slam_loop import (run_slam_course,
                                                slam_batch_init)
    from tpunav_torch.sim import dense_world

    cfg = harness.config(cell["config"])
    mix = dict(harness.traffic(cell["traffic"]), **(sizes or {}))
    b = mix.get("seeds_per_sweep", cfg["sweep_seeds"])
    ticks = mix.get("sweep_ticks", cfg["sweep_ticks"])
    dev = torch.device(device)
    dep = dense_world.deployment(mix.get("rollouts", cfg["rollouts"]), dev)
    seeds, tick0, _ = draws(seed, mix["sweeps"], b, dev)
    st = slam_batch_init(dep.mppi, dep.ekf,
                         [s for row in seeds[:sweeps] for s in row],
                         pose_xyt=list(dep.start), device=dev)
    st.ticks.copy_(tick0[:sweeps].flatten())
    t0 = time.perf_counter()
    st, _ = run_slam_course(dep.mppi, dep.ekf, dep.loop, dep.model,
                            dep.waypoints, dep.landmarks, st, ticks,
                            meas_fn=dep.meas_fn, meas_shape=dep.meas_shape,
                            chunk=mix["chunk_ticks"])
    truth = st.true_pose[:, :2].double()
    slam = torch.hypot(*(st.ekf.state[:, 1:3].double() - truth).T)
    odom = torch.hypot(*(st.odom[:, 1:3].double() - truth).T)
    worst = lambda e: e.view(sweeps, b).amax(dim=1).tolist()  # noqa: E731
    return {"seed": seed, "sweeps": sweeps,
            "seconds": time.perf_counter() - t0, "slam_m": worst(slam),
            "odom_m": worst(odom),
            "finite": bool(torch.isfinite(slam).all())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sweeps", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 3
    cell = {c["name"]: c for c in harness.benchmark()["workloads"]}[
        args.workload]
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload,
                           **end_errors(cell, seed, args.sweeps)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
