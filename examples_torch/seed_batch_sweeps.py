"""The seed sweeps of ``make_results`` rows 1-3, batched and serial, side by
side: each seed's numbers from both, and the two wall times.

    python -m examples_torch.seed_batch_sweeps [--rows 1,2,3] [--seeds 20]
        [--steps 400] [--ticks 5000] [--rollouts 2048] [--device cuda]
        [--out PATH]

Row 1 and row 2 are the lidar EKF's sweeps, known and unknown DA
(``lidar_ekf_slam_demo.run_many``: 400 steps); row 3 is config 4's
(``dense_world_slam_demo.run_batch``: 5,000 ticks at K=2,048). Each row
runs its seeds as one batch (one graph replay per step or chunk for every
seed) and then one after another through each seed's own course
(``lidar_ekf_slam_demo.make_sim``'s, ``dense_world_slam_demo.build``'s),
and prints one JSON line: the wall seconds of each, the graphs' warm-ups
and captures included, whether every seed's final errors, landmark count
(and for row 3 waypoint visits) are bit-equal, and where not, the first
seed that differs and the largest gap. On the card each line carries the
card's name and power limit. ``--out`` also writes the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

from examples_torch import dense_world_slam_demo, synchronize
from examples_torch import lidar_ekf_slam_demo as lidar
from tpunav_torch.device import DEFAULT_DEVICE, resolve


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.splitlines()[0]


def compare(batched: dict, serial: dict) -> dict:
    """Per key, whether the two sweeps' per-seed arrays are bit-equal, and
    for those that are not, the first seed that differs and the largest
    gap."""
    out = {}
    for key, a in batched.items():
        a, b = np.asarray(a), np.asarray(serial[key])
        common = np.result_type(a, b)           # counts: int32 or int64
        a, b = a.astype(common), b.astype(common)
        rows = [i for i in range(len(a)) if a[i].tobytes() != b[i].tobytes()]
        out[key] = ({"equal": True} if not rows else {
            "equal": False, "first_seed_index": rows[0],
            "max_abs_gap": float(np.abs(a.astype(np.float64)
                                        - b.astype(np.float64)).max())})
    return out


def serial(row: int, seeds, steps=400, device=DEFAULT_DEVICE, ticks=5000,
           rollouts=2048):
    """Row ``row``'s sweep seed after seed, each through its own course:
    ({name: per-seed array}, seconds, the graphs' warm-ups and captures
    included), the names and order of :func:`sweep`'s batch. On ``device``,
    default the card (raises without CUDA unless ``device="cpu"``)."""
    device = resolve(device)
    synchronize(device)
    t0 = time.perf_counter()
    if row == 3:
        course = dense_world_slam_demo.build(ticks, rollouts, device)[0]
        outs = [course(seed, telemetry=False) for seed in seeds]
        out = {key: np.asarray([o[key] for o in outs])
               for key in ("ekf_err", "odo_err", "count", "visits")}
    else:
        known = row == 1
        step, _, cfg = lidar.CONFIGS["known" if known else "unknown"]
        sim = lidar.make_sim(step, cfg, known, steps, device)
        ends = [sim(seed) for seed in seeds]
        errs = [lidar.errors(*end[:3]) for end in ends]
        out = {"ekf_err": np.asarray([e[0] for e in errs]),
               "odo_err": np.asarray([e[1] for e in errs]),
               "count": np.asarray([int(end[2].count) for end in ends])}
    synchronize(device)
    return out, time.perf_counter() - t0


def sweep(row: int, seeds, steps=400, device=DEFAULT_DEVICE, ticks=5000,
          rollouts=2048):
    """(batched, serial) of one row: ({name: per-seed array}, seconds)
    each. ``steps``: the lidar courses'; ``ticks`` and ``rollouts``: config
    4's."""
    device = resolve(device)
    if row == 3:
        batched = dense_world_slam_demo.run_batch(seeds, ticks, rollouts,
                                                  device)
    else:
        known = row == 1
        step, _, cfg = lidar.CONFIGS["known" if known else "unknown"]
        e_s, e_o, counts, wall = lidar.run_many(step, cfg, known, seeds,
                                                steps, device=device)
        batched = ({"ekf_err": e_s, "odo_err": e_o, "count": counts}, wall)
    return batched, serial(row, seeds, steps, device, ticks, rollouts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,2,3")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--steps", type=int, default=400,
                    help="steps of the lidar EKF courses (rows 1-2)")
    ap.add_argument("--ticks", type=int, default=5000,
                    help="ticks of config 4's course (row 3)")
    ap.add_argument("--rollouts", type=int, default=2048,
                    help="K of config 4's solves (row 3)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve(args.device)
    seeds = list(range(args.seeds))
    lines = []
    for row in (int(r) for r in args.rows.split(",")):
        (bat, bat_s), (ser, ser_s) = sweep(row, seeds, args.steps, device,
                                           args.ticks, args.rollouts)
        line = json.dumps({
            "row": row, "seeds": len(seeds), "batched_s": bat_s,
            "serial_s": ser_s, "per_seed": compare(bat, ser),
            "device": str(device), "card": _card(device)})
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
