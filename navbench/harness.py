"""The benchmark's runner: one cell, one seed, one window.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. Each
is a data file found by its name: ``configs/<config>.json`` and
``traffic/<traffic>.json``. The traffic file names the driver
(``drivers/<driver>.py``) that builds the system under test from both,
runs its timed steps, and checks what they produced against the plain
reference (``reference/``). Each per-layer metric is a reader of its own,
``metrics/<name>.py``, that takes its number from a profiled stretch of the
window, or returns None where that stretch holds nothing for it.

A run: set-up (the program's state made on the device from the seed, every
shape warmed up and captured), then the window of ``--seconds``, then the
check, then one JSON line. ``--trace 1`` profiles a bounded stretch inside
the window and reports the per-layer metrics instead of the end-to-end
ones.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpunav")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO, "BENCHMARK.json")


def discover() -> Dict[str, List[str]]:
    """The names of the configuration, traffic and metric files present."""
    out = {}
    for kind, ext in (("configs", ".json"), ("traffic", ".json"),
                      ("metrics", ".py")):
        names = [f[:-len(ext)] for f in os.listdir(os.path.join(ROOT, kind))
                 if f.endswith(ext) and not f.startswith("_")]
        out[kind] = sorted(names)
    return out


def config(name: str) -> dict:
    return load_json(ROOT, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(ROOT, "traffic", f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"navbench.drivers.{name}")


def reader(name: str):
    """``metrics/<name>.py``'s ``read``, or where that file is missing the
    one of the name's first part (``device_idle_pct.slam`` is read by
    ``device_idle_pct.py``); a name may hold dots, so the file is loaded
    by its path."""
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    if not os.path.exists(path):
        name = name.split(".", 1)[0]
        path = os.path.join(ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"navbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``tpunav_torch`` is not ``tpunav``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def host_info() -> dict:
    """The cores this process may run on and the one it ran on last
    (``/proc/self/stat``), read after the window: the host's side of a
    run's speed."""
    out = {"cores_allowed": len(os.sched_getaffinity(0)),
           "cores": os.cpu_count()}
    try:
        with open("/proc/self/stat") as f:
            out["last_core"] = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        pass
    return out


def device_info(torch, memory_peak: int, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(memory_peak)}


def checked(readings: dict, limits: dict):
    """({name: (value, limit)} of the numbers that have a limit, {name:
    value} of the others); a run that reached no sampled step fails."""
    if not readings:
        return {"sampled_steps_missing": (1.0, 0.0)}, {}
    return ({k: (v, limits[k]) for k, v in readings.items() if k in limits},
            {k: v for k, v in readings.items() if k not in limits})


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: Optional[float] = None,
             sizes: Optional[dict] = None) -> dict:
    """One run of ``cell`` (an entry of ``workloads``). ``device`` and
    ``sizes`` (traffic overrides) exist for the tests, which run the same
    path on the CPU at small sizes; the command line passes neither.
    Returns the result's fields and ``checks``."""
    import torch

    started = time.perf_counter() if started is None else started
    bench = benchmark()
    cfg = config(cell["config"])
    mix = dict(traffic(cell["traffic"]), **(sizes or {}))
    drv = driver(mix["driver"]).Driver(cfg, mix, seed, torch.device(device))
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started

    stretch, ctx = None, None
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if trace and stretch is None and now >= t0 + seconds / 3:
            from . import trace as tr
            # Late in a process the profiler can drop a kernel's record:
            # a stretch whose counts disagree with the launch counters is
            # profiled again, up to three times.
            for _ in range(3):
                stretch = drv.tally()
                ctx = tr.profile_stretch(drv.step, mix["trace_steps"])
                after = drv.tally()
                ctx["delta"] = {k: after[k] - stretch[k] for k in after}
                if tr.all_sound(ctx):
                    break
            end += time.perf_counter() - now
            continue
        drv.step()
    if device != "cpu":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)

    attempted, failed = drv.outcome()
    e2e = drv.metrics(window_s)
    drv.release()
    checks, info = checked(drv.readings(), drv.limits)
    correct = (attempted > 0 and failed == 0 and
               all(v <= lim for v, lim in checks.values()))

    unit = {m["name"]: m["unit"] for m in bench["end_to_end"] +
            bench["per_layer"]}
    metrics, extra = {}, {}
    if trace:
        if ctx is None:
            raise RuntimeError("the window ended before its traced stretch")
        ctx.update(drv.trace_info())
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        from .trace import breakdown
        extra["breakdown"] = breakdown(ctx)
        dev = {"busy_s": ctx["busy_s"], "window_s": ctx["window_s"]}
    else:
        e2e["setup_s"] = setup_s
        for m in bench["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": unit[m["name"]]}
        dev = {}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "memory_peak": memory_peak, "dev": dev,
            "extra": extra, "checks": checks, "info": info,
            "window_s": window_s}


def main(argv=None) -> int:
    started = time.perf_counter()
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cells = {c["name"]: c for c in benchmark()["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    # One process with one host thread of its own: the card's host side is
    # single-threaded, and idle worker threads only compete for the cores
    # that launch the graphs.
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
              f"{cell['chips']}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   started=started)
    found = forbidden_modules()
    if found:
        print(f"modules of {found} were loaded in the benchmark's process",
              file=sys.stderr)
        return 4
    checks = {name: {"value": v, "limit": lim}
              for name, (v, lim) in out["checks"].items()}
    for name, v in out["info"].items():
        print(f"info {name}: {v!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": dict(device_info(torch, out["memory_peak"],
                                       cell["chips"]), **out["dev"])}
    line.update(out["extra"])
    line["host"] = host_info()
    line["info"] = out["info"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
