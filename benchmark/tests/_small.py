"""Shared by the harness tests: a cell of BENCHMARK.json cut to a size the
CPU proves in seconds, run through the harness on the CPU (the kernels'
plain versions) with the reference in this process."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def small_cell(name: str, n: int = 16):
    cell = harness.resolve(harness.load_spec(), name)
    cell.config = dict(cell.config, group_order=n)
    if "n_gates" in cell.config:
        cell.config.update(n_gates=n - 8, table_bits=4)
    cell.traffic = dict(cell.traffic, pool=2, check_sample=2, trace_requests=1)
    if cell.traffic.get("batch"):
        cell.traffic.update(batch=2, pool=4, check_sample=4)
    return cell


def run_small(name: str, n: int = 16, seconds: float = 0.5, seed: int = 2**40 + 7, fault=None):
    return harness.run(small_cell(name, n), seed, seconds, trace=False, device="cpu",
                       fault=fault, workers=1)
