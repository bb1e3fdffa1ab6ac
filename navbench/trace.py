"""A profiled stretch of the window: torch.profiler over a few steps, read
from its Chrome trace.

The stretch opens on 32 spin kernels and a synchronize, so the first step
does not start the profiler's timeline cold, and is marked by a host span
(``navbench.stretch``) that ends after a closing synchronize. The traced
window runs from the first device operation launched inside that span to
the end of the last. From the trace come every device operation (kernel,
copy, set) with its start and length, and the host's runtime calls and
operators, which label the device's idle gaps. The kernels' launch
counters (``tpunav_torch.capture.read_counts``) are read before and after,
so a reader can hold the profiler's kernel counts against them.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

STRETCH = "navbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")

# The profiler's kernel names of each launch counter's family (K1's
# combine kernel follows its partials one for one).
FAMILIES = {"K1": "mppi_rollout_partials", "K2": "likelihood_",
            "K3": "map_update_kernel", "K4": "edt_kernel"}


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted (start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def read_trace(path: str) -> dict:
    """The stretch of a Chrome trace: {"window_s", "busy_s", "ops": [(name,
    start_us, dur_us)], "gaps": [(start_us, end_us)], "host": [(name,
    start_us, end_us)]}; times in the trace's microseconds. The device
    operations are those launched inside the stretch's span; the window
    runs from the first one's start to the last one's end, and ``busy_s``
    is the union of their intervals in it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and
             e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} stretch spans in the trace")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if a >= t0 and a < t1:
                ops.append((e["name"], a, min(d, t1 - a)))
        elif e.get("cat") in HOST_CATS and _overlap(a, a + d, t0, t1) > 0:
            host.append((e["name"], max(a, t0), min(a + d, t1)))
    busy = _union([(a, a + d) for _, a, d in ops])
    if not busy:
        raise RuntimeError("no device operation in the traced stretch")
    # The traced window: the stretch's first device operation to the end of
    # its last, so the host's work before the first launch is not counted
    # as the device's idle time.
    t0, t1 = busy[0][0], busy[-1][1]
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:])]
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "ops": ops, "gaps": gaps, "host": host}


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing in them (the runtime call or operator that
    overlaps a gap most; ``host:python`` where none does), in seconds."""
    by_op: Dict[str, float] = defaultdict(float)
    for name, _, d in tr["ops"]:
        by_op[name[:120]] += d * 1e-6
    host = sorted(tr["host"], key=lambda h: h[1])
    by_gap: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in tr["gaps"]:
        while j < len(host) and host[j][2] < a:
            j += 1
        best, label = 0.0, "host:python"
        for name, h0, h1 in host[j:]:
            if h0 > b:
                break
            ov = _overlap(a, b, h0, h1)
            if ov > best:
                best, label = ov, f"host:{name[:100]}"
        by_gap[label] += (b - a) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


def profile_stretch(step: Callable[[], None], steps: int) -> dict:
    """Profile ``steps`` calls of ``step``: the stretch read by
    :func:`read_trace`, with ``kernels`` ({name: (seconds, count)}),
    ``counters`` (each launch counter's change) and ``profiled`` (the
    profiler's kernel count of each counted family)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpunav_torch.capture import read_counts

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        before = read_counts()
        with record_function(STRETCH):
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        after = read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = read_trace(path)
    kernels: Dict[str, list] = {}
    for name, _, d in tr["ops"]:
        s = kernels.setdefault(name, [0.0, 0])
        s[0] += d * 1e-6
        s[1] += 1
    tr["kernels"] = {k: tuple(v) for k, v in kernels.items()}
    tr["counters"] = {k: after[k] - before[k] for k in FAMILIES}
    tr["profiled"] = {k: sum(c for name, (_, c) in tr["kernels"].items()
                             if tag in name)
                      for k, tag in FAMILIES.items()}
    tr["steps"] = steps
    return tr


def family_seconds(ctx: dict, tag: str) -> float:
    """Device seconds of the kernels whose names hold ``tag``."""
    return sum(s for name, (s, _) in ctx["kernels"].items() if tag in name)


def family_seconds_per_launch(ctx: dict, key: str, tag: str = ""):
    """A counted family's device seconds (of the kernels named ``tag``, by
    default the family's own) per recorded launch, or None where it did not
    run or the profiler recorded more kernels than the counter launched.
    Late in a process the profiler can drop a record (it never adds one); a
    time per recorded launch stays sound."""
    rec = ctx["profiled"][key]
    if rec == 0 or rec > ctx["counters"][key]:
        return None
    return family_seconds(ctx, tag or FAMILIES[key]) / rec


def all_sound(ctx: dict) -> bool:
    """True where no counted family lost a record."""
    return all(ctx["profiled"][k] == ctx["counters"][k] for k in FAMILIES)


def nearly_sound(ctx: dict, steps: int) -> bool:
    """True where no family has more records than launches and none is
    ``steps`` or more records short: the rule under which a stretch whose
    profiler dropped a record still gives its device time."""
    return all(0 <= ctx["counters"][k] - ctx["profiled"][k] < steps
               for k in FAMILIES)
