"""The readings that the limits of ``correct`` are set from: for each seed,
a short window of the cell as its runs drive it, then each compared number
of the program and of the control (the reference in bfloat16 put in the
program's place). The benchmark's own runs never run this.

    python3 -m navbench.calibrate --workload <name> --seeds 1,2,3
        [--seconds 3] [--control-seeds n] [--out <JSON-lines file>]

One JSON line per seed: {"seed", "program": {...}, "control": {...}}.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import harness


def readings(cell: dict, seed: int, seconds: float, device="cuda",
             sizes=None, control=True) -> dict:
    """The program's readings after one short window, and the control's
    where ``control``."""
    cfg = harness.config(cell["config"])
    mix = dict(harness.traffic(cell["traffic"]), **(sizes or {}))
    t0 = time.perf_counter()
    drv = harness.driver(mix["driver"]).Driver(cfg, mix, seed,
                                               torch.device(device))
    setup = time.perf_counter() - t0
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        drv.step()
    attempted, failed = drv.outcome()
    drv.release()
    t1 = time.perf_counter()
    program = drv.readings()
    t2 = time.perf_counter()
    control = drv.readings(torch.bfloat16) if control else None
    return {"seed": seed, "setup_s": setup, "attempted": attempted,
            "failed": failed, "reference_s": t2 - t1,
            "control_s": time.perf_counter() - t2,
            "program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first this many seeds "
                    "only (default all)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 3
    cell = {c["name"]: c for c in harness.benchmark()["workloads"]}[
        args.workload]
    seeds = [int(s) for s in args.seeds.split(",")]
    n_ctl = len(seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(seeds):
        line = json.dumps({"workload": args.workload,
                           **readings(cell, seed, args.seconds,
                                      control=i < n_ctl)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
