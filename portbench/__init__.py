"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: cells,
configurations, traffic and per-layer readers, found by the names in
``BENCHMARK.json``.  Run a cell with ``python3 portbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
