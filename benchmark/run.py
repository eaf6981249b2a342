"""Benchmark entry: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output; the numbers
compared for `correct`, each with its limit, go last on standard error.
Needs an NVIDIA card: without one it exits 1 and prints no result."""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # Caches of the program's builds stay in the checkout, at fixed paths.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "benchmark", ".cache", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "benchmark", ".cache", "triton"))
    sys.path[0] = ROOT  # the checkout, not this folder: its modules would shadow others
    from benchmark.harness import main

    sys.exit(main(t0=T0))
