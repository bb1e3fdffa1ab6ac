"""navbench: the benchmark of ``tpunav_torch``, the port's PyTorch and
CUDA program, on one NVIDIA H100.

``python3 -m navbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line; ``README.md`` sets out the files and how to add to them.
"""
