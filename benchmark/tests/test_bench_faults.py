"""`correct` turns false under the control and under each fault of the
timed path (benchmark/control.py), on the CPU at tiny sizes; on a card,
the control at a size a test run holds.

    python -m pytest benchmark/tests -q          # the CPU tests
    python -m pytest benchmark/tests -q -m cuda  # on a card
"""

import pytest

from _small import run_small, small_cell

from benchmark import control, harness

CASES = [
    ("chain-n262144-single", "stale"),
    ("chain-n262144-single", "altered"),
    ("chain-n262144-batch", "half_batch"),
    ("turbo-lookup-n262144-single", "altered"),
]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(cell, fault):
    n = 32 if cell.startswith("turbo") else 16
    result, _ = run_small(cell, n=n, seconds=0.2, fault=getattr(control, fault))
    assert not result["correct"], result["checks"]


def test_control_turns_correct_false():
    with control.reduced_precision():
        result, _ = run_small("chain-n262144-single", seconds=0.2)
    assert not result["correct"]
    assert result["checks"]["commits_wrong"]["value"] > 0


@pytest.mark.cuda
def test_control_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = small_cell("chain-n262144-single", n=1 << 14)
    sound, _ = harness.run(cell, 5, 2.0, trace=False, workers=2)
    with control.reduced_precision():
        broken, _ = harness.run(cell, 5, 2.0, trace=False, workers=2)
    assert sound["correct"] and not broken["correct"]
