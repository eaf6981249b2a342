"""The benchmark's harness on the CPU at tiny sizes: its files against
BENCHMARK.json, the traffic's seeding, the window's arithmetic, the plain
reference against the program, the refusal without a card and the imports.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from _small import ROOT, run_small

from benchmark import check, harness

SPEC = harness.load_spec()
BENCH = os.path.join(ROOT, "benchmark")


def test_files_found_by_name_match_the_spec():
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for conf in SPEC["configs"]:
        data = harness.load_json(conf["file"])
        assert conf["file"].startswith("benchmark/configs/")
        assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]
        assert os.path.exists(os.path.join(BENCH, "families", data["family"] + ".py"))
        assert all(k in data for k in conf["reduced"])
        assert data["reference"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, data["reference"]))
        assert isinstance(check.reference(data).LIMITS, dict)
    for w in SPEC["workloads"]:
        cell = harness.resolve(SPEC, w["name"])
        assert cell.traffic["pool"] >= max(cell.traffic.get("batch", 1), 1)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    assert {m["moves"] for m in SPEC["per_layer"]} <= e2e


@pytest.mark.parametrize("cell", ["chain-n262144-single", "turbo-lookup-n262144-single"])
def test_traffic_is_the_seeds(cell):
    c = harness.resolve(SPEC, cell)
    fam = __import__(f"benchmark.families.{c.config['family']}", fromlist=["x"])
    big = 2**31 + 11
    one = harness.draw(big, fam, c.config, c.traffic)
    again = harness.draw(big, fam, c.config, c.traffic)
    other = harness.draw(10**12 + 39, fam, c.config, c.traffic)
    assert one[:2] == again[:2] and one[2].random() == again[2].random()
    assert one[0] != other[0] and one[1] != other[1]
    assert len(one[1]) == c.traffic["pool"]


@pytest.fixture(scope="module")
def chain_run():
    return run_small("chain-n262144-single", seconds=0.5)


def test_window_counts_whole_requests(chain_run):
    result, run = chain_run
    done = [r.done for r in run.requests]
    assert run.window_s == done[-1] >= 0.5 and all(d < 0.5 for d in done[:-1])
    assert all(len(r.proofs) == 1 and not r.error for r in run.requests)
    assert result["metrics"]["proofs_per_s"]["value"] == pytest.approx(len(done) / done[-1])
    assert result["attempted"] == len(done) and result["failed"] == 0
    assert set(result["metrics"]) == {"proofs_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def test_reference_agrees_with_the_chain(chain_run):
    result, _ = chain_run
    assert result["correct"], result["checks"]
    assert result["checks"]["proofs_checked"]["value"] >= 1


def test_reference_agrees_with_turbo_lookup():
    result, _ = run_small("turbo-lookup-n262144-single", n=32, seconds=0.2)
    assert result["correct"], result["checks"]


def test_refuses_without_a_card(tmp_path):
    # The checkout as it stands, and a directory holding only the
    # benchmark's own files: neither prints a result here, where no card is.
    only = tmp_path / "only"
    shutil.copytree(BENCH, only / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), only)
    args = ["--workload", "chain-n262144-single", "--seed", "3", "--seconds", "1", "--trace", "0"]
    for cwd in (ROOT, str(only)):
        proc = subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stdout


def test_judge_leaves_no_process():
    # Two workers judge a batch's proofs in spawned processes; the pool's
    # resource tracker has ended by the time the result is made.
    from multiprocessing import resource_tracker

    from _small import small_cell

    result, _ = harness.run(small_cell("chain-n262144-batch"), 2**40 + 7, 0.2, trace=False,
                            device="cpu", workers=2)
    assert result["correct"] and result["checks"]["proofs_checked"]["value"] >= 2
    assert resource_tracker._resource_tracker._pid is None


FORBIDDEN = {"jax", "jaxlib", "flax", "plonkathon_tpu", "chip_smoke", "scripts"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_and_a_reference_of_its_own():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
            if os.sep + "reference" + os.sep in path:
                assert not tops & {"plonkathon_tpu_torch", "torch", "benchmark"}, path


def test_arrivals_closed_and_open():
    import random

    assert harness.arrivals({}, random.Random(1), 10.0) is None
    due = harness.arrivals({"rate_per_s": 4.0}, random.Random(1), 10.0)
    assert due == harness.arrivals({"rate_per_s": 4.0}, random.Random(1), 10.0)
    assert due[0] == 0.0 and all(a < b < 10.0 for a, b in zip(due, due[1:])) and 20 < len(due) < 60


def test_trace_readers_on_a_known_trace():
    from benchmark.trace import Trace, breakdown, kernel_name

    assert kernel_name("k4_dense_kernel(int*)") == "k4_dense_kernel"
    assert kernel_name("void at::native::elementwise_kernel<128>(int)").startswith("torch:")
    tr = Trace(
        kernels=[("k2_kernel", 100, 200), ("k3_kernel", 150, 300), ("torch:add", 500, 600),
                 ("k1_kernel", 650, 700)],
        host=[("request", 0, 1000), ("round_1", 0, 450), ("aten::copy_", 320, 480)],
        window=(0, 1000),
    )
    assert tr.busy_intervals() == [[100, 300], [500, 600], [650, 700]]
    assert tr.busy_s() == pytest.approx(350e-6)
    assert tr.idle_gaps() == [(0, 100), (300, 500), (600, 650), (700, 1000)]
    b = breakdown(tr)
    assert b["idle_gaps"][0] == ["request", 300e-6]
    assert b["idle_gaps"][1] == ["round_1 > aten::copy_", 200e-6]
    assert b["device_ops"][0] == ["k3_kernel", 150e-6]
    run = harness.Run(cell=None, trace=tr, traced_proofs=2)
    got = {m: harness.reader(m)(run) for m in (
        "kernels_per_proof", "msm_device_ms_per_proof", "ntt_device_ms_per_proof",
        "field_device_ms_per_proof", "device_idle_pct")}
    assert got == pytest.approx({"kernels_per_proof": 2.0, "msm_device_ms_per_proof": 0.075,
                                 "ntt_device_ms_per_proof": 0.05, "field_device_ms_per_proof": 0.075,
                                 "device_idle_pct": 65.0})
