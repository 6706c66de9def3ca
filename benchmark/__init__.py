"""The benchmark of realsr_tpu_torch on NVIDIA cards: ``python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the repository's root (``BENCHMARK.json`` names the cells)."""
