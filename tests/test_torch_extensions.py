"""Extensions of the JAX package that are outside the port's first slice
(custom gates, PlonKup lookups, ZK blinding rows, a device mesh) raise
NotImplementedError naming the ROADMAP item that brings them (CPU).
"""

import os

import pytest

from plonkathon_tpu_torch import Program, Prover, Setup
from plonkathon_tpu_torch.config import ProverConfig

PTAU = os.path.join(os.path.dirname(__file__), "fixtures", "powersOfTau28_hez_final_11.ptau")


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(lines=["y <== x * x * x"], custom_gates=True), "item 9"),
        (dict(lines=["x lookup", "y <== x * x"], lookup_table=[0, 1, 2]), "item 9"),
        (dict(lines=["c <== a * b"], blinding_rows=3), "item 9"),
        (dict(lines=["c <== a * b"], mesh=True), "item 11"),
    ],
    ids=["custom-gates", "lookups", "blinding", "mesh"],
)
def test_extensions_outside_the_slice_raise(kwargs, match):
    setup = Setup.from_file(PTAU, device="cpu")
    mesh = kwargs.pop("mesh", False)
    lines = kwargs.pop("lines")
    program = Program(lines, 8, device="cpu", **kwargs)
    config = ProverConfig(mesh=object()) if mesh else None
    with pytest.raises(NotImplementedError, match=match):
        Prover(setup, program, config=config, device="cpu")
