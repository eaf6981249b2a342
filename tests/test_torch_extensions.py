"""Extensions of the JAX package through the port's prover (CPU): ZK
blinding rows, alone and composed at the Program level with a lookup table
or with cube gates, prove and verify under both port verifiers and the JAX
package's host verifier (by integer coordinates); a mesh that is not the
port's Mesh raises TypeError (tests/test_torch_sharded.py proves
with one).
"""

import os

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup
from plonkathon_tpu_torch.config import ProverConfig

from _torch_jax_bridge import jax_proof, jax_vk

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

PTAU = os.path.join(os.path.dirname(__file__), "fixtures", "powersOfTau28_hez_final_11.ptau")


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(lines=["c <== a * b"], blinding_rows=3, inputs={"a": 3, "b": 4}), None),
        (dict(lines=["x lookup", "y <== x * x"], lookup_table=[0, 1, 2],
              blinding_rows=2, inputs={"x": 2}), None),
        (dict(lines=["y <== x * x * x"], custom_gates=True, blinding_rows=2,
              inputs={"x": 3}), None),
        (dict(lines=["c <== a * b"], mesh=True), "Mesh"),
    ],
    ids=["blinding", "blinding-with-lookups", "blinding-with-cube-gates", "mesh"],
)
def test_extensions_outside_the_slice_raise(setup, kwargs, match):
    mesh = kwargs.pop("mesh", False)
    lines = kwargs.pop("lines")
    inputs = kwargs.pop("inputs", None)
    program = Program(lines, 8, device="cpu", **kwargs)
    if mesh:
        with pytest.raises(TypeError, match=match):
            Prover(setup, program, config=ProverConfig(mesh=object()), device="cpu")
        return
    witness = program.fill_variable_assignments(inputs)
    proof = Prover(setup, program, device="cpu").prove(dict(witness))
    vk = setup.verification_key(program.common_preprocessed_input())
    assert vk.verify_proof(8, proof, [])
    assert vk.verify_proof_unoptimized(8, proof, [])
    assert jax_vk(vk).verify_proof(8, jax_proof(proof), [])
    # ...and not against a public input it was not made for.
    assert not vk.verify_proof(8, proof, [1])
