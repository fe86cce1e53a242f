"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness, yardstick and plain references.  ``python3 bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json``."""
