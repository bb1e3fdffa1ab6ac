"""The bus's publish cost, the two-process lockstep rate and the EKF update
through ``EKFStepper`` of one checkout of the port, on a CUDA card.

    python3 examples_torch/ab_rates.py [--root DIR] [--label NAME]

Imports ``tpunav_torch``, ``examples_torch`` and ``chip_smoke`` from DIR
(default: this checkout), so two checkouts unpacked side by side can be
compared within one run of a machine (A B B A). Prints one JSON line:

- ``publish_us``: host µs per ``NetChannel.publish`` of a (4,) float64
  array on a topic with one subscriber in another client of the same
  process (a broker on localhost), over 2,000 publishes after 100;
- ``lockstep_cycles_per_s``: ``two_process``'s laptop rate
  (``examples_torch.full_stack_two_process.run_two_process``: the robot
  on the CPU and the laptop on the card, 150 cycles at K=4,096);
- ``ekf_update_ms``: ms per ``EKFStepper.step`` on the host's clock (the
  median of 5 trials of 40 replays, after 20 updates of ``bench.py``'s
  course), known and unknown data association, without and with the
  default SPD repair, at ``bench_ekf``'s shape (capacity 50, 12 visible).

Imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch


def publish_us(count=2000, warm=100):
    from tpunav_torch.runtime.net import BusClient, BusServer, wait_for_new

    srv = BusServer()
    try:
        a, b = BusClient(srv.host, srv.port), BusClient(srv.host, srv.port)
        sub, pub = b.subscribe("t"), a.advertise("t")
        payload = np.zeros(4)
        for _ in range(warm):
            pub.publish(payload)
        t0 = time.perf_counter()
        for _ in range(count):
            pub.publish(payload)
        us = 1e6 * (time.perf_counter() - t0) / count
        wait_for_new(sub, warm + count - 1, timeout=30)
        a.close()
        b.close()
    finally:
        srv.close()
    return us


def lockstep_rate():
    from examples_torch.full_stack_two_process import run_two_process

    with tempfile.TemporaryDirectory() as d:
        return run_two_process(d, 150, 4096, "cuda")[2]


def ekf_update_ms(trials=5, reps=40):
    import dataclasses

    from chip_smoke import bench_ekf_course
    from tpunav_torch.estimation.ekf import filter as ekff

    dev = torch.device("cuda")
    meas = [torch.as_tensor(m, dtype=torch.float32, device=dev)
            for m in bench_ekf_course()]
    u = torch.tensor([0.02, 0.01], dtype=torch.float32, device=dev)
    base = ekff.EKFConfig(num_landmarks=50, dmin=5e1, dmax=1e4,
                          measurement_noise=(1e-4, 1e-4))
    out = {}
    for repair in (False, True):
        cfg = dataclasses.replace(base, spd_repair=repair)
        for known in (True, False):
            a = ekff.ekf_init(cfg, dtype=torch.float32, device=dev)
            stepper = ekff.EKFStepper(cfg, a, 50, known)
            for m in meas[:20]:
                stepper.step(m, u)
            times = []
            for _ in range(trials):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    stepper.step(meas[-1], u)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0) / reps)
            out[f"{'known' if known else 'unknown'}"
                f"{'_spd_repair' if repair else ''}"] = {
                    "median": statistics.median(times), "trials": times}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_rates.py: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke

    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    print(json.dumps({"label": args.label, "root": root,
                      "publish_us": publish_us(),
                      "lockstep_cycles_per_s": lockstep_rate(),
                      "ekf_update_ms": ekf_update_ms(), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
