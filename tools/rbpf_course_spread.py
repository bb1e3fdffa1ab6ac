"""The spread of the port's RBPF course error over scan-noise draws and
filter seeds, on a CUDA card.

    python3 tools/tpunav_course_scans.py     # once, on a host with JAX
    python3 tools/rbpf_course_spread.py

Runs chip_smoke.py's ``rbpf_course`` configuration (P=500, k=50, 80×80,
360 beams, 120 updates of the bench's box-world course) through the port,
from filter seeds 0, 1 and 2, on each scan set: the port's own scans with
range noise drawn from generator seeds 7 (chip_smoke.py's) to 11, and,
where tools/out/tpunav_course_scans.npz exists, the same course's scans
as ``tpunav`` draws them. Prints one JSON line per scan set with the best
particle's |xy| error in cm per filter seed, then a summary line. Imports
nothing of JAX.
"""

import json
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SEEDS = (0, 1, 2)
PORT_SCAN_SEEDS = (7, 8, 9, 10, 11)
TPUNAV = os.path.join(ROOT, "tools", "out", "tpunav_course_scans.npz")


def main() -> int:
    if not torch.cuda.is_available():
        print("rbpf_course_spread.py: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    rb = chip_smoke.Rbpf(card)
    sets = {f"port_gen{s}": rb.course_inputs(s) for s in PORT_SCAN_SEEDS}
    if os.path.exists(TPUNAV):
        d = np.load(TPUNAV)
        dev = rb.dev
        odoms = [torch.from_numpy(o).to(dev) for o in d["odoms"]]
        prevs = [torch.zeros(3, device=dev)] + odoms[:-1]
        u = torch.tensor([0.03, 0.02], device=dev)
        for name, scans in zip(d["names"], d["scans"]):
            sets[str(name)] = (u, [torch.from_numpy(s).to(dev)
                                   for s in scans], odoms, prevs)
    errs = {}
    for name, inputs in sets.items():
        errs[name] = {seed: rb.pose_error_cm(seed, inputs) for seed in SEEDS}
        print(json.dumps({"scans": name, "pose_error_cm": errs[name]}),
              flush=True)

    def summary(names):
        vals = [e for n in names for e in errs[n].values()]
        return {"courses": len(vals), "mean": statistics.mean(vals),
                "min": min(vals), "max": max(vals)}

    port = [n for n in errs if n.startswith("port_")]
    other = [n for n in errs if not n.startswith("port_")]
    out = {"port_scans": summary(port)}
    if other:
        out["tpunav_scans"] = summary(other)
    print(json.dumps({"summary": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
