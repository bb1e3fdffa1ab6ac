"""The eigensolver's A phase in each layout that holds a size, on a CUDA
card.

    python3 examples_torch/sym_eig_layouts.py [S ...]   # default 17 53 103 167

For each S (> 8), runs ``sym_eig.eigh`` on one symmetric matrix from a
numpy seed with A placed in each layout of ``sym_eig.LAYOUTS`` that fits
the card's shared memory at that S (``sym_eig.layout`` picks one of
them; the others are forced here), in turns (the order reversed every
other turn), and prints one JSON line per S: the CUDA-event ms per call
of each layout (the median of each turn's calls), whether all layouts
gave the same bits, and the layout ``layout`` picks. Then the card's name
and power limit. Imports nothing of JAX.
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
from tpunav_torch.ops import sym_eig as se  # noqa: E402

REGION = {"shared_packed": lambda n: 4 * n * (n + 1),   # keep in step with
          "global_packed": lambda n: 0}                  # sym_eig.layout


def forced(kind, real):
    """``sym_eig.layout`` with A placed in ``kind`` for S > 8."""
    def layout(n, smem_limit):
        picked, region, smem = real(n, smem_limit)
        if n <= se.SMALL_MAX:
            return picked, region, smem
        region_k = REGION[kind](n)
        return kind, region_k, smem - region + region_k
    return layout


def event_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("sym_eig_layouts.py: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    sizes = [int(x) for x in sys.argv[1:]] or [17, 53, 103, 167]
    limit = chip_smoke.smem_limit()
    real = se.layout
    rng = np.random.default_rng(5)
    for n in sizes:
        x = rng.standard_normal((n, n))
        a = torch.from_numpy(x + x.T).cuda()
        extras = real(n, limit)[2] - real(n, limit)[1]
        kinds = [k for k in REGION if extras + REGION[k](n) <= limit]
        ms = {k: [] for k in kinds}
        out = {}
        try:
            for turn in range(4):
                for k in (kinds if turn % 2 == 0 else kinds[::-1]):
                    se.layout = forced(k, real)
                    out[k] = se.eigh(a)
                    ms[k].append(event_ms(lambda: se.eigh(a), 20))
        finally:
            se.layout = real
        w0, v0 = out[kinds[0]]
        same = all(torch.equal(w, w0) and torch.equal(v, v0)
                   for w, v in out.values())
        print(json.dumps({"S": n, "picked": real(n, limit)[0],
                          "ms_by_turn": ms,
                          "ms_median": {k: statistics.median(v)
                                        for k, v in ms.items()},
                          "same_bits": same, "card": card}), flush=True)
        if not same:
            return 1
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
