"""The port's fidelity tables, ``RESULTS_torch.md``, beside ``tpunav``'s.

Counterpart of ``make_results.py`` (which writes ``RESULTS.md``). Each
closed-loop configuration runs over seeds; rows give the seed-0 error per
axis, mean ± std and the worst case over the seeds, and the full stack a
success rate. The rows, as ``tpunav``'s:

1. EKF SLAM, known DA — lidar raycast → circle detector → filter
   (ref table: nuslam/README.md:24-34)
2. EKF SLAM, unknown DA at 50-landmark capacity, 12-cylinder world
   (ref: nuslam/README.md:39-50)
3. Dense-world unknown DA — 44 cylinders through the lidar detector, MPPI
   (kernel K1) in the loop (config 4 at its stated scale)
4. RBPF grid SLAM, 500 particles under the fused-MPPI exploration loop
   (kernels K1–K4; ref table: bmapping/README.md:33-47 at 40 particles)
5. The full stack (RBPF map → D* Lite replanning → fused MPPI): success
   rate
6. The exploration loop's per-scan budget, with launches and host syncs

Beside each row stands ``tpunav``'s line for the same row, read from
``RESULTS.md``'s section of that heading: its seed-0 errors and its
statistics (errors, landmark counts, success rates), never a rate or a
time, which were taken on a TPU.

    python -m examples_torch.make_results [--rows 1,2] [--seeds 20]
        [--device cuda]

``--rows`` runs only the rows named and replaces only their sections of an
existing output file, so the table can be built over several runs; each
row names the device, the torch version, the commit, the date and its seed
count. Nothing here imports matplotlib.
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
import subprocess

import numpy as np
import torch

from tpunav_torch.device import resolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SEEDS = 20
FS_SEEDS = 10
STEPS = 400              # the lidar EKF courses' steps
TITLE = "# RESULTS_torch — the port's closed-loop fidelity beside tpunav's"

HEADINGS = {
    1: "EKF SLAM (known DA, lidar→detector)",
    2: "EKF SLAM (unknown DA, Mahalanobis, capacity 50)",
    3: "Dense-world EKF SLAM (unknown DA, 44 cylinders, MPPI in the loop)",
    4: "RBPF grid SLAM (500 particles, MPPI exploration loop K=2048)",
    5: "Full navigation stack (beyond-reference integration)",
    6: "Closed-loop RBPF per-scan budget (config 5)",
}
REFERENCE = {
    1: "nuslam/README.md:24-34 (x 0.000, y 0.000, yaw 0.008°; odom "
       "0.030/0.099/−7.964°)",
    2: "nuslam/README.md:39-50 (x −0.008, y 0.038, yaw −1.633°; odom "
       "0.015/0.084/−6.975°)",
    3: "nuslam/README.md:39-50 — the reference's unknown-DA table is a "
       "12-landmark world at visibility 0.6 m; this world is ~4x larger "
       "with detector-based perception",
    4: "bmapping/README.md:33-47 (x −1.04 cm, y 3.81 cm, yaw 1.98°; odom "
       "19.5/−10.5 cm, 2.62°)",
}
# A number with a unit of time or rate: never quoted from tpunav's file.
_RATE = re.compile(r"\d\s*(ms|µs|s|/s|updates/s|ticks/s|solves/s)\b")


def fmt_err(e):
    return (f"x {e[1]:+.4f} m, y {e[2]:+.4f} m, "
            f"yaw {np.degrees(e[0]):+.3f}°")


def fmt_stats(errs):
    """errs: (S, 3) [θ, x, y] → mean±std |xy| + yaw, worst case."""
    xy = np.hypot(errs[:, 1], errs[:, 2])
    yaw = np.degrees(np.abs(errs[:, 0]))
    return (f"|xy| {xy.mean()*100:.2f} ± {xy.std()*100:.2f} cm "
            f"(worst {xy.max()*100:.2f}), "
            f"|yaw| {yaw.mean():.2f} ± {yaw.std():.2f}° "
            f"(worst {yaw.max():.2f})")


def tpunav_lines(row: int, path=os.path.join(ROOT, "RESULTS.md")):
    """``tpunav``'s fidelity lines for ``row`` from ``RESULTS.md``'s
    section of the same heading: the seed-0 table rows and the statistics,
    or the full stack's paragraph; none for the per-scan budget, which is
    a TPU time. Raises if a quoted line holds a rate or a time."""
    if row == 6:
        return []
    with open(path, encoding="utf-8") as f:
        text = f.read()
    section = text.split(f"## {HEADINGS[row]}\n", 1)[1].split("\n## ", 1)[0]
    keep = [line for line in section.splitlines()
            if line.startswith(("| **SLAM**", "| odometry only",
                                "Statistics:", "Full stack"))]
    for line in keep:
        if _RATE.search(line):
            raise ValueError(f"a rate or time in tpunav's row {row}: {line}")
    return keep


def tpunav_block(row: int):
    """``tpunav``'s lines for ``row`` as they stand under the port's row:
    its seed-0 table, then its statistics, quoted."""
    ref = tpunav_lines(row)
    if not ref:
        return ["`tpunav`'s row is a per-scan time on a TPU: not quoted.",
                ""]
    table = [line for line in ref if line.startswith("|")]
    out = ["`tpunav`, the same row (RESULTS.md, a TPU v5e run; errors, "
           "landmark counts and success rates only):", ""]
    if table:
        out += ["| | tpunav pose error (seed 0) |", "|---|---|"] + table + [
            ""]
    return out + [f"> {line}" for line in ref
                  if not line.startswith("|")] + [""]


def provenance(device, commit) -> str:
    """The device (the card's name and power limit), torch, the commit and
    the date of a run."""
    if torch.device(device).type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0].strip()
    else:
        smi = "the CPU (no card)"
    when = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%d %H:%M UTC")
    return f"{smi}; torch {torch.__version__}; commit {commit}; {when}"


def default_commit() -> str:
    try:
        return subprocess.run(["git", "describe", "--always", "--dirty"],
                              cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not recorded (no git checkout)"


def _error_row(slam, odo, stats, config, row):
    return [
        "| | pose error (seed 0) |", "|---|---|",
        f"| **SLAM** | {fmt_err(slam)} |",
        f"| odometry only | {fmt_err(odo)} |", "",
        f"Statistics: {stats}.", "", f"Config: {config}.",
        f"Reference: {REFERENCE[row]}.", ""]


def row_ekf(row: int, seeds, steps, device):
    from examples_torch.lidar_ekf_slam_demo import CONFIGS, run, run_many

    known = row == 1
    step, _, cfg = CONFIGS["known" if known else "unknown"]
    ekf_err, odo_err, n_lm, _, _, _ = run(step, cfg, known, steps,
                                          device=device)
    e_s, e_o, counts, wall = run_many(step, cfg, known, seeds, steps,
                                      device=device)
    stats = (f"{len(seeds)} seeds: SLAM {fmt_stats(e_s)}; odometry "
             f"{fmt_stats(e_o)}")
    if known:
        config = (f"{n_lm}/12 landmarks, {steps} steps, 12-cylinder block "
                  f"world, 360-beam lidar σ=1e-3; {len(seeds)}-seed sweep "
                  f"in {wall:.1f} s (the seeds as one batch: one graph "
                  f"replay per step for all, each seed its serial "
                  f"course's bits)")
    else:
        stats += (f"; landmarks tracked {counts.mean():.1f} ± "
                  f"{counts.std():.1f}")
        config = (f"{n_lm} landmarks tracked (seed 0), {steps} steps, same "
                  f"world; {len(seeds)}-seed sweep in {wall:.1f} s (one "
                  f"batch)")
    return _error_row(ekf_err, odo_err, stats, config, row)


def row_dense(seeds, device):
    from examples_torch.dense_world_slam_demo import run_batch

    dw, wall = run_batch(seeds, device=device)
    s, o, c, v = dw["ekf_err"], dw["odo_err"], dw["count"], dw["visits"]
    stats = (f"{len(seeds)} seeds: SLAM {fmt_stats(s)}; odometry "
             f"{fmt_stats(o)}; landmarks tracked {c.mean():.1f} ± "
             f"{c.std():.1f} of 44 true, waypoints reached {v.mean():.1f}")
    config = ("lidar → clustering+circle-fit detector → capacity-50 gating, "
              "K=2048 MPPI (K1) closed loop, 5000 ticks @ 20 Hz, odometry "
              f"bias 1e-4/tick; {len(seeds)}-seed sweep in {wall:.1f} s (the "
              "seeds as one batch: each replayed chunk advances all of "
              "them, one K1 launch a tick for the B solves)")
    return _error_row(s[0], o[0], stats, config, 3)


def row_rbpf(seeds, device):
    from examples_torch.rbpf_explore_demo import run_experiment, seed_sweep

    r = run_experiment(device=device)
    sw_s, sw_o = seed_sweep(seeds=tuple(seeds), device=device)
    stats = (f"{len(seeds)} filter seeds (40-scan course): SLAM "
             f"{fmt_stats(sw_s)}; odometry {fmt_stats(sw_o)}")
    config = (f"{r['n_scans']} scans @ {r['updates_per_sec']:.1f} updates/s "
              f"closed loop (median {r['updates_per_sec_median']:.1f}), "
              f"{r['mppi_solves']} fused solves, {r['occupied_cells']} "
              f"occupied cells, torque-capped motor dynamics (τ=50 ms), "
              f"reference-scale odometry drift, checkpoint/restore mid-run "
              f"(resumed chunk bit-equal to the in-memory one: "
              f"{r['resume_bit_equal']})")
    return _error_row(r["slam_err"], r["odom_err"], stats, config, 4)


def row_full_stack(fs_seeds, device):
    from examples_torch.full_stack_demo import run

    runs = []
    for s in range(fs_seeds):
        fs = run(verbose=False, seed=5 + s, device=device)
        runs.append(fs)
        print(f"full stack seed {5 + s}: reached={fs['reached']} "
              f"goal_err={fs['final_goal_err_m'] * 100:.1f} cm", flush=True)
    n_ok = sum(f["reached"] for f in runs)
    goal = np.asarray([f["final_goal_err_m"] for f in runs])
    slam = np.asarray([f["slam_vs_true_m"] for f in runs])
    scans = np.asarray([f["scans"] for f in runs])
    return [
        f"Full stack (RBPF map → D* Lite replanning → fused MPPI, one "
        f"loop): goal reached in {n_ok}/{fs_seeds} seeded runs through an "
        f"initially-unknown barrier; final goal error "
        f"{goal.mean() * 100:.1f} ± {goal.std() * 100:.1f} cm (worst "
        f"{goal.max() * 100:.1f}), SLAM-vs-truth {slam.mean() * 100:.1f} ± "
        f"{slam.std() * 100:.1f} cm; {scans.mean():.0f} scans on average "
        f"(examples_torch/full_stack_demo.py, seeds 5–{4 + fs_seeds}).", ""]


def row_budget(device):
    from examples_torch.profile_rbpf_stages import profile_closed_loop

    budget = profile_closed_loop(device=device)
    lines = ["| stage | per scan |", "|---|---|"]
    for name, v in budget.items():
        unit = "" if name.endswith("per scan") else " ms"
        lines.append(f"| {name} | {v:.2f}{unit} |")
    return lines + [
        "",
        "CUDA-event ms per scan of each stage from marks between its "
        "CUDA graphs, chained over 10 scans of the exploration "
        "(examples_torch/profile_rbpf_stages.py: ChainedStages), their sum "
        "beside the exploration's one ScanGraph replay per scan. Launches "
        "per chained scan from torch.profiler, host syncs from torch's "
        "sync debug mode.", ""]


def build_row(row: int, seeds, fs_seeds, steps, device):
    if row in (1, 2):
        return row_ekf(row, seeds, steps, device)
    if row == 3:
        return row_dense(seeds, device)
    if row == 4:
        return row_rbpf(seeds, device)
    if row == 5:
        return row_full_stack(fs_seeds, device)
    return row_budget(device)


def _sections(path):
    """{heading: lines} of an existing output file's rows."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        parts = f.read().split("\n## ")[1:]
    return {p.split("\n", 1)[0]: p.split("\n", 1)[1].rstrip("\n").split("\n")
            for p in parts}


def write(path, sections, provenance_line):
    lines = [
        TITLE, "",
        "Written by `python -m examples_torch.make_results` "
        "(`examples_torch/`, the PyTorch + CUDA port). All errors are "
        "final pose errors against simulation ground truth; odometry error "
        "is the dead-reckoned pose of the same run. Seed-0 rows give the "
        "per-axis breakdown, the seed statistics the spread (mean ± std, "
        "worst case). Under each row, `tpunav`'s line for the same row "
        "(RESULTS.md, from a TPU v5e run: errors, landmark counts and "
        "success rates only). Each row names its own run.", "",
        f"Last run: {provenance_line}.", ""]
    for row in sorted(HEADINGS):
        body = sections.get(HEADINGS[row])
        if body is not None:
            lines += [f"## {HEADINGS[row]}"] + body + [""]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines).rstrip("\n") + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,2,3,4,5,6",
                    help="comma-separated rows to run (1-6), in this order")
    ap.add_argument("--seeds", type=int, default=N_SEEDS,
                    help=f"seeds of rows 1-4 (and of row 5, at most "
                         f"{FS_SEEDS})")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps of the lidar EKF courses (rows 1-2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--commit", default=None,
                    help="the commit to name (default: git describe)")
    ap.add_argument("--out", default=os.path.join(ROOT, "RESULTS_torch.md"))
    args = ap.parse_args(argv)
    rows = list(dict.fromkeys(int(r) for r in args.rows.split(",")))
    if not set(rows) <= set(HEADINGS):
        raise SystemExit(f"rows must be among {sorted(HEADINGS)}")
    resolve(args.device)             # raises without CUDA, before any run
    prov = provenance(args.device, args.commit or default_commit())
    seeds = list(range(args.seeds))
    fs_seeds = min(args.seeds, FS_SEEDS)
    sections = _sections(args.out)
    for row in rows:
        body = build_row(row, seeds, fs_seeds, args.steps, args.device)
        count = {1: f"{args.seeds} seeds", 2: f"{args.seeds} seeds",
                 3: f"{args.seeds} seeds", 4: f"{args.seeds} filter seeds",
                 5: f"{fs_seeds} seeded runs", 6: "one run"}[row]
        if row in (1, 2) and args.steps != STEPS:
            count += f", {args.steps} steps (not {STEPS})"
        sections[HEADINGS[row]] = (["", f"Run: {prov}; {count}.", ""] +
                                   body + tpunav_block(row))
        write(args.out, sections, prov)
        print(f"row {row} done: {HEADINGS[row]}", flush=True)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
