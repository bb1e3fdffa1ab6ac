"""One run of a benchmark cell with the program's tracer
(``tpunav_torch.runtime.profiling``): what the tracer read without the
profiler, beside the cell's end-to-end metrics and, where asked, the
profiler's view of a stretch of the same window.

    python tools/trace_cell.py --workload <cell> --seed <n> --seconds <s> \\
        [--tracer 0|1] [--profile 0|1]

Run from the root of a checkout, on the card. It runs the cell as
``navbench.harness.run_cell`` does (the cell's driver built from its
configuration and traffic files, the window, the check), with the tracer
switched on before the driver is built where ``--tracer 1``, and with one
profiled stretch (``navbench.trace.profile_stretch``, the traced runs'
stretch) a third of the way in where ``--profile 1``. It prints one JSON
line:

- ``metrics``: the cell's end-to-end metrics over the window, ``correct``;
- ``window``: the replays of the cell's graphs in the window (their
  ``replays`` counters) and the window's seconds;
- ``tracer``: ``profiling.summary()`` after the window, the change of its
  counts over the window, and the readings the tracer gives: ``launch_us``
  (host µs a ``graph.launch`` span), ``replay_ms`` (device ms a replay),
  ``replay_idle_pct`` (the device idle between replays) and
  ``icp_device_ms`` (the ``pf.icp`` phase's device ms an update, where at
  least 100 updates were read);
- ``stretch``: the profiler's device operations, kernel launches and busy
  time per replay in its stretch, its idle share and idle gaps.

A checkout without the tracer (``profiling.enable``) runs with
``--tracer 0`` alone.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import warnings

ICP_MIN_UPDATES = 100


def readings(summary: dict) -> dict:
    """The tracer's per-layer numbers from ``profiling.summary()``."""
    out = {}
    launch = summary["spans"].get("graph.launch")
    if launch:
        out["launch_us"] = launch["mean_us"]
    rep = summary["replays"]
    if rep["device_ms"] is not None:
        out["replay_ms"] = rep["device_ms"]
        out["replay_idle_pct"] = rep["idle_pct"]
    icp = summary["phases"].get("pf.icp")
    if icp and icp["count"] >= ICP_MIN_UPDATES:
        out["icp_device_ms"] = icp["mean_ms"]
    return out


def _counts(summary: dict) -> dict:
    rep = summary["replays"]
    icp = summary["phases"].get("pf.icp", {"count": 0, "missed": 0})
    return {"timed": rep["timed"], "profiled": rep["profiled"],
            "in_flight": rep["in_flight"], "icp_read": icp["count"],
            "icp_missed": icp["missed"]}


def run(cell: dict, seed: int, seconds: float, tracer: bool,
        profile: bool, device: str = "cuda",
        sizes: dict | None = None) -> dict:
    import torch

    from navbench import harness
    from tpunav_torch import capture
    from tpunav_torch.runtime import profiling

    cuda = device != "cpu"
    if tracer:
        profiling.enable(True)
    cfg = harness.config(cell["config"])
    mix = dict(harness.traffic(cell["traffic"]), **(sizes or {}))
    drv = harness.driver(mix["driver"]).Driver(cfg, mix, seed,
                                               torch.device(device))
    with warnings.catch_warnings():    # isinstance on deprecated aliases
        warnings.simplefilter("ignore", FutureWarning)
        graphs = [g for g in gc.get_objects()
                  if isinstance(g, capture.Graph)]
    if cuda:
        torch.cuda.synchronize()
    replays0 = sum(g.replays for g in graphs)
    start = _counts(profiling.summary()) if tracer else None

    stretch = None
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if profile and stretch is None and now >= t0 + seconds / 3:
            stretch = _stretch(drv, mix["trace_steps"], graphs)
            end += time.perf_counter() - now
            continue
        drv.step()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    out = {"window": {"seconds": window_s,
                      "replays": sum(g.replays for g in graphs) - replays0}}
    if tracer:
        s = profiling.summary()
        stop = _counts(s)
        out["tracer"] = {"readings": readings(s), "summary": s,
                         "counts": {k: stop[k] - start[k] for k in stop
                                    if k != "in_flight"}}
        out["tracer"]["counts"]["in_flight"] = stop["in_flight"]
        profiling.enable(False)
    attempted, failed = drv.outcome()
    e2e = drv.metrics(window_s)
    drv.release()
    checks, _ = harness.checked(drv.readings(), drv.limits)
    out["correct"] = (attempted > 0 and failed == 0 and
                      all(v <= lim for v, lim in checks.values()))
    out["metrics"] = e2e
    if stretch is not None:
        out["stretch"] = stretch
    return out


def _stretch(drv, steps: int, graphs) -> dict:
    """The profiler's view of ``steps`` steps, per replay."""
    from navbench import trace as tr

    from tpunav_torch.runtime import profiling

    before = sum(g.replays for g in graphs)
    ctx = tr.profile_stretch(drv.step, steps)
    n = sum(g.replays for g in graphs) - before
    out = {"replays": n, "ops_per_replay": len(ctx["ops"]) / n,
           "launches_per_replay": {k: v / n for k, v in
                                   ctx["counters"].items()},
           "busy_ms_per_replay": ctx["busy_s"] * 1e3 / n,
           "window_ms": ctx["window_s"] * 1e3,
           "device_idle_pct": 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"]),
           "idle_gaps": tr.breakdown(ctx)["idle_gaps"]}
    if getattr(profiling, "ON", False):
        # The tracer timed the same replays, kept apart as profiled.
        timed = [t1 - t0 for t0, t1, _, profiled
                 in profiling.records()["replays"] if profiled][-n:]
        out["tracer_replay_ms"] = sum(timed) * 1e-6 / len(timed)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    from navbench import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the tracer's readings come from the card",
              file=sys.stderr)
        return 3
    cells = {c["name"]: c for c in harness.benchmark()["workloads"]}
    out = run(cells[args.workload], args.seed, args.seconds,
              bool(args.tracer), bool(args.profile))
    out.update(workload=args.workload, seed=args.seed,
               traced=args.tracer, profiled=args.profile,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
