"""Extensions of the JAX package that the port does not have yet raise
NotImplementedError naming the ROADMAP Queue 1 item that brings them (CPU):
ZK blinding rows (item 3), alone and composed at the Program level with a
lookup table or with cube gates, and a device mesh (item 6).
"""

import os

import pytest

from plonkathon_tpu_torch import Program, Prover, Setup
from plonkathon_tpu_torch.config import ProverConfig

PTAU = os.path.join(os.path.dirname(__file__), "fixtures", "powersOfTau28_hez_final_11.ptau")


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(lines=["c <== a * b"], blinding_rows=3), "item 3"),
        (dict(lines=["x lookup", "y <== x * x"], lookup_table=[0, 1, 2],
              blinding_rows=2), "item 3"),
        (dict(lines=["y <== x * x * x"], custom_gates=True, blinding_rows=2), "item 3"),
        (dict(lines=["c <== a * b"], mesh=True), "item 6"),
    ],
    ids=["blinding", "blinding-with-lookups", "blinding-with-cube-gates", "mesh"],
)
def test_extensions_outside_the_slice_raise(kwargs, match):
    setup = Setup.from_file(PTAU, device="cpu")
    mesh = kwargs.pop("mesh", False)
    lines = kwargs.pop("lines")
    # The frontend composes blinding rows with lookups and cube gates (as
    # the JAX package's does); the port's prover refuses them.
    program = Program(lines, 8, device="cpu", **kwargs)
    config = ProverConfig(mesh=object()) if mesh else None
    with pytest.raises(NotImplementedError, match=match):
        Prover(setup, program, config=config, device="cpu")
