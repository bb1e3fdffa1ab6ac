"""The ICP kernel on a CUDA card, one match per launch, beside its plain
version, for the checkout this script sits in.

    python3 tools/icp_times.py [--tag NAME] [--sizes 90,180,360]
                               [--iters 25,30] [--clusters 0,1,2,4,8]

The clouds are two consecutive scans of the RBPF demo's arc (0.03 rad and
0.02 m an update inside walls at ±1.8 m, 2 mm range noise) at N beams over
the full turn, with the odometry guess. Prints one JSON line per (N,
max_iter, cluster), cluster 0 standing for ``ops/icp.py:plan``'s choice
and c > 0 for a plan made to spread the rows over c blocks (its
``SMALL_N`` and ``ROWS_PER_BLOCK`` set for the line), each with the card's
name and power limit:

- ``event_us``: µs per match by CUDA events around a graph of 20 launches
  replayed (median of 5 × 10 replays), so the host's launch cost is out;
- ``device_us``: the profiler's device µs per ``icp_kernel`` launch;
- ``max_diff``: the largest difference of the six result fields from the
  plain version's on the card;
- ``bound_us``: the operations' floor, 7·N² an iteration (the search's
  subtract, square and add, ~6·N², and the rank's N² comparisons) at
  67 TFLOP/s float32.

Then one line per (N, max_iter) for the plain version: eager µs per match
(5 matches) and replayed in a graph (the whole match's ~100 operations an
iteration, as the SLAM step's graph held them before the kernel). First a
line with ptxas's report for the kernel when this process built the
library. Imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

F32_OPS_PER_S = 67e12       # NVIDIA's H100 SXM float32 peak outside tensor cores


def card_name():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def session_pair(n, dev):
    """(grid, scan, previous scan, odometry guess): updates 3 and 4 of the
    arc from the origin at (0.03 rad, 0.02 m) an update."""
    import math

    from tpunav_torch.estimation.rbpf import GridConfig
    from tpunav_torch.estimation.rbpf import particle_filter as tpf
    from tpunav_torch.sim import lidar

    grid = GridConfig(num_beams=n, beam_delta=2 * math.pi / n)
    th = 0.03 * torch.arange(1, 5, dtype=torch.float32, device=dev)
    odoms = torch.stack([th, torch.cumsum(0.02 * torch.cos(th), 0),
                         torch.cumsum(0.02 * torch.sin(th), 0)], -1)
    walls = lidar.box_segments(-1.8, -1.8, 1.8, 1.8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    scans = [lidar.scan_segments(
        pose, walls, num_beams=n, beam_min=grid.beam_min,
        beam_delta=grid.beam_delta, max_range=grid.range_max, generator=gen,
        noise_std=0.002) for pose in odoms]
    return (grid, scans[3].contiguous(), scans[2].contiguous(),
            tpf._icp_init_guess(odoms[3], odoms[2]))


def spread_over(icp_kernel, n, cluster):
    """Set the plan's constants so that it spreads ``n`` rows over
    ``cluster`` blocks (0: the plan's own constants)."""
    icp_kernel.SMALL_N = SMALL_N if cluster == 0 else (n if cluster == 1
                                                       else 0)
    icp_kernel.ROWS_PER_BLOCK = (ROWS_PER_BLOCK if cluster == 0
                                 else -(-n // cluster))


def graph_us(fn, per_graph=20, replays=10, trials=5):
    """µs per call of ``fn`` captured ``per_graph`` times in one graph."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            g.replay()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b) / (replays * per_graph))
    return statistics.median(times)


def eager_us(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--sizes", default="90,180,360")
    ap.add_argument("--iters", default="25,30")
    ap.add_argument("--clusters", default="0,1,2,4,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from examples_torch import kernel_profile
    from tpunav_torch.estimation.rbpf.icp import ICPConfig, scan_to_points
    from tpunav_torch.ops import _build
    from tpunav_torch.ops import icp as icp_kernel

    global SMALL_N, ROWS_PER_BLOCK
    SMALL_N, ROWS_PER_BLOCK = icp_kernel.SMALL_N, icp_kernel.ROWS_PER_BLOCK
    dev = torch.device("cuda", 0)
    card = card_name()
    _build.load()
    lines = _build.ptxas_report().splitlines()
    at = [i for i, line in enumerate(lines)
          if "Compiling entry function" in line and "icp_kernel" in line]
    print(json.dumps({"measure": "ptxas", "tag": args.tag, "card": card,
                      "report": [lines[j] for i in at
                                 for j in range(i, min(i + 4, len(lines)))]}),
          flush=True)
    limit = _build.load().tpunav_max_dynamic_smem()
    for n in map(int, args.sizes.split(",")):
        grid, ranges, prev, guess = session_pair(n, dev)
        src = scan_to_points(ranges, grid.range_min, grid.range_max,
                             grid.beam_min, grid.beam_delta)
        dst = scan_to_points(prev, grid.range_min, grid.range_max,
                             grid.beam_min, grid.beam_delta)
        for iters in map(int, args.iters.split(",")):
            cfg = ICPConfig(max_iter=iters)
            want = icp_kernel._icp_reference(cfg, *src, *dst, guess)
            for cluster in map(int, args.clusters.split(",")):
                spread_over(icp_kernel, n, cluster)
                plan = icp_kernel.plan(n, limit)

                def run():
                    return icp_kernel.icp_scans(
                        cfg, ranges, prev, guess, grid.range_min,
                        grid.range_max, grid.beam_min, grid.beam_delta)
                got = run()
                diff = max(float(torch.max(torch.abs(
                    a.float() - b.float()))) for a, b in zip(got, want))
                kern = kernel_profile(run, 20)
                dev_us = [us / cnt for name, (us, cnt) in kern.items()
                          if "icp_kernel" in name]
                print(json.dumps({
                    "measure": "icp_kernel", "tag": args.tag, "card": card,
                    "n": n, "max_iter": iters, "cluster": plan[0],
                    "planned": cluster == 0, "group": plan[2],
                    "layout": plan[3], "event_us": graph_us(run),
                    "device_us": dev_us[0] if dev_us else None,
                    "bound_us": 1e6 * iters * 7 * n * n / F32_OPS_PER_S,
                    "converged": bool(got[1]), "max_diff": diff}),
                    flush=True)
            spread_over(icp_kernel, n, 0)
            plain = (lambda: icp_kernel._icp_reference(cfg, *src, *dst,
                                                       guess))
            print(json.dumps({
                "measure": "icp_plain", "tag": args.tag, "card": card,
                "n": n, "max_iter": iters, "eager_us": eager_us(plain),
                "graph_us": graph_us(plain, per_graph=1, replays=5)}),
                flush=True)


if __name__ == "__main__":
    main()
