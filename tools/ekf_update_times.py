"""The EKF's cost to one seed, on a CUDA card: the update alone and the
single-seed paths that run it, for the checkout this script sits in.

    python3 tools/ekf_update_times.py [--tag NAME]

Prints one JSON line per measurement, each with the card's name and power
limit and ``--tag``:

- ``ekf_times``: the eager dynamic update at ``bench_ekf``'s shape (n=50
  capacity, 12 visible of 50 rows, float32), known and unknown DA:
  updates/s over 5 trials of 60 updates after 20 warm-up updates (median,
  min, max) and device launches per update;
- ``update_alone``: the same update through ``EKFStepper`` (one graph
  replay per update), with and without the default SPD repair: ms per
  update over 180 replays after 20, and a replayed window (device µs,
  device operations, idle share);
- ``config4_tick``: one seed's config-4 tick
  (``examples_torch.dense_world_slam_demo``, K=2,048) as 60-tick replayed
  chunks from the state after 600 ticks: µs per tick and a window;
- ``lidar_step``: one seed's lidar-EKF step (``StepGraph``), known and
  unknown DA, after 100 steps: ms per step and a window.

To compare two commits, put a copy of this file into each checkout's
``tools/`` and run both in one call on one card, in turns. Imports nothing
of JAX.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TRIALS, UPDATES, WARMUP = 5, 60, 20


def bench_cfg(ekff, **kw):
    """bench.py:bench_ekf's filter: capacity 50, the default SPD repair."""
    return ekff.EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                          measurement_noise=(1e-4, 1e-4), **kw)


def emit(card, tag, what, **fields):
    print(json.dumps({"measure": what, "tag": tag, "card": card, **fields}),
          flush=True)


def ekf_times(dev):
    from tpunav_torch.estimation.ekf import filter as ekff

    cfg = bench_cfg(ekff)
    meas = [torch.tensor(m, dtype=torch.float32, device=dev)
            for m in chip_smoke.bench_ekf_course(updates=UPDATES)]
    u = torch.tensor([0.02, 0.01], dtype=torch.float32, device=dev)
    out = {}
    for name, fn in (("known", ekff.known_correspondence_slam),
                     ("unknown", ekff.slam_unknown_da)):
        rates = []
        for trial in range(TRIALS + 1):
            st = ekff.ekf_init(cfg, dtype=torch.float32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for m in meas[:WARMUP] if trial == 0 else meas:
                st = fn(cfg, st, m, u)
            torch.cuda.synchronize()
            if trial:
                rates.append(len(meas) / (time.perf_counter() - t0))
        out[name] = {"updates_per_s": statistics.median(rates),
                     "min": min(rates), "max": max(rates),
                     "launches_per_update": chip_smoke.launches(
                         lambda: fn(cfg, st, meas[-1], u))}
    return out


def update_alone(dev):
    from tpunav_torch.estimation.ekf import filter as ekff

    meas = [torch.tensor(m, dtype=torch.float32, device=dev)
            for m in chip_smoke.bench_ekf_course()]
    u = torch.tensor([0.02, 0.01], dtype=torch.float32, device=dev)
    out = {}
    for repair in (False, True):
        cfg = bench_cfg(ekff, spd_repair=repair)
        for known in (True, False):
            stepper = ekff.EKFStepper(
                cfg, ekff.ekf_init(cfg, dtype=torch.float32, device=dev),
                50, known, dev)
            for i, m in enumerate(meas):
                stepper.step(m, u)
                if i == WARMUP - 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / (len(meas) - WARMUP)
            step = lambda: stepper.step(meas[-1], u)  # noqa: E731
            us = chip_smoke.wall_us(step, 5, warmup=0)
            key = (f"{'known' if known else 'unknown'}"
                   f"{'_spd_repair' if repair else ''}")
            out[key] = {"ms_per_update": ms,
                        "window": chip_smoke.graph_window(step, 3, 1, us)}
    return out


def config4_tick(dev, warm_ticks=600, chunk=60):
    from examples_torch import dense_world_slam_demo as demo
    from tpunav_torch.control import slam_loop as sl

    _, (mppi, ekf, loop), ring, world, meas_fn = demo.build(device=dev)
    st = sl.slam_loop_init(mppi, ekf, pose_xyt=[1.42, 0.0, math.pi / 2],
                           seed=0, device=dev)
    window = sl._Chunks(mppi, ekf, loop, demo.MODEL, ring, world, st, chunk,
                        None, meas_fn, (360,), demo.telemetry_row)
    for _ in range(warm_ticks // chunk):
        window.run()
    us = chip_smoke.wall_us(window.run, 10, warmup=0)
    return {"ticks_before": warm_ticks, "us_per_tick": us / chunk,
            "landmarks": int(window.state.ekf.count),
            "window": chip_smoke.graph_window(window.run, 2, chunk, us)}


def lidar_step(dev, warm_steps=100):
    from examples_torch import lidar_ekf_slam_demo as le

    out = {}
    for tag in ("known", "unknown"):
        step, known, cfg = le.CONFIGS[tag]
        graph = le.make_graph(step, cfg, known, dev)
        le.course(graph, cfg, 0, warm_steps)
        gen = torch.Generator(device=dev).manual_seed(1)
        run = lambda: graph.step(gen)  # noqa: E731
        us = chip_smoke.wall_us(run, 50)
        out[tag] = {"ms_per_step": us / 1e3,
                    "window": chip_smoke.graph_window(run, 3, 1, us)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default=os.path.basename(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ekf_update_times.py: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    dev = torch.device("cuda")
    torch.manual_seed(0)
    for what, fn in (("ekf_times", ekf_times),
                     ("update_alone", update_alone),
                     ("config4_tick", config4_tick),
                     ("lidar_step", lidar_step)):
        t0 = time.perf_counter()
        result = fn(dev)
        emit(card, args.tag, what, seconds=time.perf_counter() - t0,
             result=result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
