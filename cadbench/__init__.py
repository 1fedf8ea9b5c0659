"""cadbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python cadbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell, a configuration, a traffic mix or a
per-layer metric needs sits in its own file under ``workloads/``,
``configs/``, ``traffic/`` and ``metrics/``, found by name.
"""
