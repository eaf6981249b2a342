"""The port's models/ against the JAX package's (CPU, host only): the
Poseidon hash and its circuit source, and the example circuits' rows
(selectors and wires). A slow test proves the ~900-gate Poseidon circuit
at n = 1024 through the port and checks it against the host hash."""

import os

import pytest
import torch

from plonkathon_tpu.models import examples as jax_examples
from plonkathon_tpu.models import poseidon as jax_poseidon
from plonkathon_tpu_torch.models import examples, poseidon

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

PTAU = os.path.join(os.path.dirname(__file__), "fixtures", "powersOfTau28_hez_final_11.ptau")


def test_poseidon_host_hash_matches_reference():
    for in1, in2 in ((1, 2), (2, 1), (0, 0), (123456789, 2**250 + 7)):
        ours = poseidon.poseidon_hash(in1, in2)
        assert int(ours) == int(jax_poseidon.poseidon_hash(in1, in2))
    assert poseidon.poseidon_hash(1, 2) != poseidon.poseidon_hash(2, 1)
    assert poseidon.poseidon_circuit_source() == jax_poseidon.poseidon_circuit_source()


@pytest.mark.parametrize(
    "name,args",
    [
        ("three_gate_program", (8,)),
        ("factorization_program", (16,)),
        ("mul_chain_program", (10, 16)),
        ("cube_chain_program", (6, 8)),
        ("turbo_lookup_program", (12, 16, 3)),
    ],
)
def test_example_circuits_match_reference(name, args):
    ours = getattr(examples, name)(*args, device="cpu")
    theirs = getattr(jax_examples, name)(*args)
    assert ours.group_order == theirs.group_order
    assert (ours.has_custom_gates, ours.has_lookups) == (theirs.has_custom_gates, theirs.has_lookups)
    assert ours.lookup_table == theirs.lookup_table
    for c, d in zip(ours.constraints, theirs.constraints, strict=True):
        assert c.wires.as_list() == d.wires.as_list()
        assert [int(x) for x in c.selectors()] == [int(x) for x in d.selectors()]
        assert int(c.qcube()) == int(d.qcube())
    if name == "turbo_lookup_program":
        assert examples.turbo_lookup_witness(ours) == jax_examples.turbo_lookup_witness(theirs)


@pytest.mark.slow
def test_poseidon_circuit_end_to_end():
    from plonkathon_tpu_torch import Program, Prover, Setup

    setup = Setup.from_file(PTAU, device="cpu")
    expected = poseidon.poseidon_hash(1, 2)
    program = Program.from_str(poseidon.poseidon_circuit_source(), 1024, device="cpu")
    assignments = program.fill_variable_assignments({"L0": 1, "M0": 2})
    assert assignments["M64"] == expected.n
    vk = setup.verification_key(program.common_preprocessed_input())
    proof = Prover(setup, program, device="cpu").prove(assignments)
    assert vk.verify_proof(1024, proof, [1, 2, expected.n])
    assert vk.verify_proof_unoptimized(1024, proof, [1, 2, expected.n])
