"""PlonKup lookups through the port (CPU): the JAX package's
tests/test_plonkup.py on `device="cpu"`, with the JAX package's host
verifier also accepting the port's lookup proof.

The `x lookup` statement with `Program(lookup_table=...)` weaves the
plookup multiset argument into the five rounds (plonkup.py). The oracle is
the prover's debug invariants, both port verifiers, the reference's
verifier, and soundness probes (corrupted proofs, an out-of-table witness).
Where the reference's file differs: the Program-level composition of
blinding rows with a lookup table, which the port's prover refuses naming
ROADMAP Queue 1 item 3, is tests/test_torch_extensions.py's
"blinding-with-lookups" case; the batch prover's refusal of lookups waits
for the port's batch prover (Queue 1, item 5). Slow tests prove
turbo_lookup_program(48, 64, table_bits=5) and hold it field for field
against the JAX prover.
"""

import os
from dataclasses import replace

import pytest
import torch

from plonkathon_tpu_torch import Fr, Program, Prover, Setup
from plonkathon_tpu_torch.models.examples import turbo_lookup_program, turbo_lookup_witness

from _torch_jax_bridge import ints, jax_proof, jax_vk

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")

TABLE = list(range(8))  # range-check table [0, 8)
LINES = [
    "out public",
    "x lookup",
    "y lookup",
    "s <== x + y",
    "out <== s * s",
]


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


@pytest.fixture(scope="module")
def proven(setup):
    program = Program(LINES, 8, lookup_table=TABLE, device="cpu")
    prover = Prover(setup, program, debug=True, device="cpu")
    witness = program.fill_variable_assignments({"x": 3, "y": 5})
    proof = prover.prove(dict(witness))
    vk = setup.verification_key(program.common_preprocessed_input())
    return program, vk, proof


def test_plonkup_proof_verifies_both_paths(proven):
    _, vk, proof = proven
    assert vk.Qk is not None and vk.Tbl is not None and vk.t_last == Fr(7)
    assert vk.verify_proof(8, proof, [64])
    assert vk.verify_proof_unoptimized(8, proof, [64])
    # The JAX package's host verifier, on the port key's points.
    theirs_vk, theirs_proof = jax_vk(vk), jax_proof(proof)
    assert theirs_vk.verify_proof(8, theirs_proof, [64])
    assert theirs_vk.verify_proof_unoptimized(8, theirs_proof, [64])


def test_plonkup_proof_carries_lookup_fields(proven):
    _, _, proof = proven
    flat = proof.flatten()
    for k in ("f_1", "h1_1", "h2_1", "z2_1", "lk_f_eval", "lk_z2_w_eval"):
        assert k in flat
    assert len(flat) == 15 + 4 + 8


def test_out_of_table_witness_rejected(setup):
    program = Program(LINES, 8, lookup_table=TABLE, device="cpu")
    prover = Prover(setup, program, debug=True, device="cpu")
    witness = program.fill_variable_assignments({"x": 9, "y": 5})
    with pytest.raises(ValueError, match="not in the table"):
        prover.prove(dict(witness))


def test_corrupted_lookup_eval_rejected(proven):
    _, vk, proof = proven
    bad_evals = dict(proof.msg_4.lookup_evals)
    bad_evals["z2_w"] = bad_evals["z2_w"] + Fr(1)
    bad = replace(proof, msg_4=replace(proof.msg_4, lookup_evals=bad_evals))
    assert not vk.verify_proof(8, bad, [64])
    assert not vk.verify_proof_unoptimized(8, bad, [64])


def test_corrupted_z2_commitment_rejected(proven):
    _, vk, proof = proven
    from plonkathon_tpu_torch.ec import G1

    bad = replace(proof, msg_2=replace(proof.msg_2, z2_1=G1))
    assert not vk.verify_proof(8, bad, [64])
    assert not vk.verify_proof_unoptimized(8, bad, [64])


def test_wrong_public_input_rejected(proven):
    _, vk, proof = proven
    assert not vk.verify_proof(8, proof, [63])


@pytest.mark.slow
def test_turbo_plus_lookup_proof_verifies():
    program = turbo_lookup_program(48, 64, table_bits=5, device="cpu")
    assert program.has_custom_gates and program.has_lookups
    setup = Setup.from_file(PTAU, device="cpu")
    proof = Prover(setup, program, debug=True, device="cpu").prove(
        dict(turbo_lookup_witness(program))
    )
    vk = setup.verification_key(program.common_preprocessed_input())
    assert vk.verify_proof(64, proof, [])
    assert vk.verify_proof_unoptimized(64, proof, [])


@pytest.mark.slow
def test_both_provers_agree_on_turbo_lookup():
    from plonkathon_tpu.kzg import Setup as JSetup
    from plonkathon_tpu.models.examples import turbo_lookup_program as jax_turbo_lookup
    from plonkathon_tpu.prover import Prover as JProver

    program = turbo_lookup_program(48, 64, table_bits=5, device="cpu")
    witness = turbo_lookup_witness(program)
    ours = Prover(Setup.from_file(PTAU, device="cpu"), program, device="cpu").prove(
        dict(witness)
    ).flatten()
    theirs = JProver(JSetup.from_file(PTAU), jax_turbo_lookup(48, 64, table_bits=5)).prove(
        dict(witness)
    ).flatten()
    assert set(ours) == set(theirs)
    for key in ours:
        assert ints(ours[key]) == ints(theirs[key]), f"proof field {key} diverges"
