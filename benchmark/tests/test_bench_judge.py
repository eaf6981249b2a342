"""A configuration names its own judge (`reference`) and SRS size
(`srs_powers`): the present cells' compared numbers as they stand, and a
blinded configuration built here, run through the harness with the judge
of its own in _zk_judge.py, on the CPU at tiny sizes.

    python -m pytest benchmark/tests -q
"""

import sys
import types

import pytest

from _small import run_small

from benchmark import check, control, harness
from benchmark.families import chain

# Every present cell's compared numbers: name, kind of limit, limit, in order.
CHECKS = [
    ("proofs_missing", "limit", 0),
    ("commits_wrong", "limit", 0),
    ("quotient_wrong", "limit", 0),
    ("evals_wrong", "limit", 0),
    ("openings_wrong", "limit", 0),
    ("proofs_checked", "at_least", 1),
]
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_present_cells_compare_what_they_did(cell):
    result, _ = run_small(cell, n=32 if cell.startswith("turbo") else 16, seconds=0.2)
    got = [(k, *(item for item in c.items() if item[0] != "value")) for k, c in result["checks"].items()]
    assert got == [(k, (kind, limit)) for k, kind, limit in CHECKS]
    assert result["correct"], result["checks"]


def _rows(cfg):
    """The chain that fills the rows the blinding leaves: n - t lines."""
    return {"group_order": cfg["group_order"] - cfg["blinding_rows"] + 2}


@pytest.fixture
def zk_cell(monkeypatch):
    """A blinded chain, n = 16 with t = 4 blinding rows, its SRS n + 3
    powers, judged by _zk_judge.py; its family is registered here."""
    fam = types.ModuleType("benchmark.families.zk_chain")
    fam.lines = lambda cfg: chain.lines(_rows(cfg))
    fam.witness = lambda cfg, inp: chain.witness(_rows(cfg), inp)
    fam.inputs, fam.table = chain.inputs, chain.table
    fam.program_options = lambda cfg: {"blinding_rows": cfg["blinding_rows"]}
    monkeypatch.setitem(sys.modules, fam.__name__, fam)
    config = {"name": "zk-chain-n16", "family": "zk_chain", "group_order": 16, "blinding_rows": 4,
              "srs_powers": 19, "reference": "benchmark/tests/_zk_judge.py"}
    traffic = {"loop": "closed", "clients": 1, "entry": "Prover.prove", "pool": 2,
               "check_sample": 2, "trace_requests": 1}
    e2e = [m for m in harness.load_spec()["end_to_end"] if m["name"] in ("proofs_per_s", "setup_s")]
    return harness.Cell(name="zk-chain-n16-single", chips=1, config=config, traffic=traffic,
                        end_to_end=e2e, per_layer=[])


@pytest.mark.parametrize("case", ["sound", "stale", "unblinded"])
def test_blinded_configuration_with_a_judge_of_its_own(zk_cell, case):
    fault = control.stale if case == "stale" else None
    if case == "unblinded":  # the program run without its blinding rows
        sys.modules["benchmark.families.zk_chain"].program_options = lambda cfg: {}
    result, run = harness.run(zk_cell, 2**33 + 5, 0.5, trace=False, device="cpu",
                              fault=fault, workers=1)
    checks = result["checks"]
    assert list(checks) == ["proofs_missing", "wires_unblinded", "a_1_repeated", "proofs_checked"]
    assert all(len(r.proofs) == 1 and not r.error for r in run.requests)
    assert checks["proofs_missing"]["value"] == 0 and checks["proofs_checked"]["value"] >= 1
    assert result["correct"] == (case == "sound"), checks
    if case == "stale":
        assert checks["a_1_repeated"]["value"] > 0
    if case == "unblinded":
        assert checks["wires_unblinded"]["value"] == 3 * checks["proofs_checked"]["value"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("srs_powers", [True, False])
def test_srs_size_is_the_configurations(zk_cell, monkeypatch, srs_powers):
    from plonkathon_tpu_torch import Setup

    sizes = []

    def generate(n, **kw):
        sizes.append(n)
        raise _Stop  # the size is all this test reads

    monkeypatch.setattr(Setup, "generate", staticmethod(generate))
    if not srs_powers:
        del zk_cell.config["srs_powers"]
    with pytest.raises(_Stop):
        harness.run(zk_cell, 3, 0.1, trace=False, device="cpu", workers=1)
    assert sizes == [19 if srs_powers else 16]


@pytest.mark.parametrize("path", [
    "plonkathon_tpu_torch/verifier.py",
    "benchmark/../plonkathon_tpu_torch/verifier.py",
    "/benchmark/reference/plonk.py",
    "benchmark/reference/plonk.txt",
    "benchmark",
])
def test_a_judge_outside_the_benchmark_is_refused(path):
    with pytest.raises(SystemExit):
        check.reference({"reference": path})

