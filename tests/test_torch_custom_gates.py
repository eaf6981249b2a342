"""The TurboPlonK cube gate through the port (CPU): the JAX package's
tests/test_custom_gates.py on `device="cpu"`, and the JAX package's host
verifier accepting the port's cube-gate proof.

One row `c <== a * a * a` replaces two vanilla rows: the circuit gains a
QCUBE selector column, the quotient the term q_cube * A^3, the
linearization QCUBE * a_eval^3, and the key a ninth commitment (None for
vanilla circuits, whose snarkjs layout tests/test_torch_vkeys.py pins,
with the vanilla key of VANILLA_LINES below).
A slow test holds a cube-chain proof field for field against the JAX
prover's.
"""

import os

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup

from _torch_jax_bridge import ints, jax_proof, jax_vk

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")

CUBE_LINES = ["out public", "b <== a * a * a", "out <== b * b * b"]
VANILLA_LINES = ["out public", "a2 <== a * a", "b <== a2 * a", "b2 <== b * b", "out <== b2 * b"]


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


@pytest.fixture(scope="module")
def cube(setup):
    program = Program(CUBE_LINES, 8, custom_gates=True, device="cpu")
    witness = program.fill_variable_assignments({"a": 3})
    proof = Prover(setup, program, debug=True, device="cpu").prove(dict(witness))
    return setup.verification_key(program.common_preprocessed_input()), proof


@pytest.fixture(scope="module")
def vanilla(setup):
    """The same function through vanilla gates only."""
    program = Program(VANILLA_LINES, 8, device="cpu")
    witness = program.fill_variable_assignments({"a": 3})
    proof = Prover(setup, program, device="cpu").prove(dict(witness))
    return setup.verification_key(program.common_preprocessed_input()), proof, witness


def test_cube_gate_witness_fill():
    program = Program(CUBE_LINES, 8, custom_gates=True, device="cpu")
    assert program.has_custom_gates
    w = program.fill_variable_assignments({"a": 3})
    assert w["b"] == 27
    assert w["out"] == 27**3


def test_cube_gate_rejected_without_flag():
    with pytest.raises(ValueError):
        Program(["b <== a * a * a"], 8, device="cpu")


def test_cube_gate_prove_verify(cube):
    vk, proof = cube
    assert vk.Qcube is not None
    assert vk.verify_proof(8, proof, [27**3])
    assert vk.verify_proof_unoptimized(8, proof, [27**3])
    # Wrong public input must be rejected.
    assert vk.verify_proof(8, proof, [42]) is False


def test_cube_gate_matches_vanilla_semantics(vanilla):
    # The same function via vanilla gates verifies against the same public
    # output (a different circuit: its own key and proof).
    vk_v, proof_v, wv = vanilla
    assert wv["out"] == 27**3
    assert vk_v.verify_proof(8, proof_v, [27**3])


def test_reference_host_verifier_accepts_port_cube_proof(cube):
    """The JAX package's verifier (host arithmetic), given the port key's
    points and the port proof's fields, accepts it and still rejects a
    wrong public input."""
    vk, proof = cube
    theirs_vk, theirs_proof = jax_vk(vk), jax_proof(proof)
    assert theirs_vk.verify_proof(8, theirs_proof, [27**3])
    assert theirs_vk.verify_proof_unoptimized(8, theirs_proof, [27**3])
    assert not theirs_vk.verify_proof(8, theirs_proof, [42])


@pytest.mark.slow
def test_both_provers_agree_on_cube_chain():
    from plonkathon_tpu.kzg import Setup as JSetup
    from plonkathon_tpu.models.examples import cube_chain_program as jax_cube_chain
    from plonkathon_tpu.prover import Prover as JProver
    from plonkathon_tpu_torch.models.examples import cube_chain_program

    program = cube_chain_program(12, 16, device="cpu")
    witness = program.fill_variable_assignments({"x0": 3})
    ours = Prover(Setup.from_file(PTAU, device="cpu"), program, device="cpu").prove(
        dict(witness)
    ).flatten()
    theirs = JProver(JSetup.from_file(PTAU), jax_cube_chain(12, 16)).prove(
        dict(witness)
    ).flatten()
    assert set(ours) == set(theirs)
    for key in ours:
        assert ints(ours[key]) == ints(theirs[key]), f"proof field {key} diverges"
