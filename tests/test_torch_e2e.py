"""The port's main path against the JAX package's pinned fixtures (CPU):
Setup.from_file -> Program -> Prover.prove -> VerificationKey.verify_proof.

* proof.pickle verifies under both port verifiers;
* the port prover (debug=True) reproduces proof.pickle field for field;
* prove/verify round trips (the factorization circuit at n = 16 is in
  tests/test_torch_vkeys.py);
* the prover's per-round Timings and the torch.profiler trace helpers.
A slow test runs both provers on the factorization circuit and compares
every proof field.
"""

import os

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup, load_proof_pickle
from plonkathon_tpu_torch.transcript import Message1

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")
THREE_GATE = ["e public", "c <== a * b", "e <== c * d"]
ASSIGNMENTS = {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}
FACTOR_SRC = """n public
pb0 === pb0 * pb0
pb1 === pb1 * pb1
pb2 === pb2 * pb2
pb3 === pb3 * pb3
qb0 === qb0 * qb0
qb1 === qb1 * qb1
qb2 === qb2 * qb2
qb3 === qb3 * qb3
pb01 <== pb0 + 2 * pb1
pb012 <== pb01 + 4 * pb2
p <== pb012 + 8 * pb3
qb01 <== qb0 + 2 * qb1
qb012 <== qb01 + 4 * qb2
q <== qb012 + 8 * qb3
n <== p * q"""
FACTOR_BITS = {"pb3": 1, "pb2": 1, "pb1": 0, "pb0": 1, "qb3": 0, "qb2": 1, "qb1": 1, "qb0": 1}


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


@pytest.fixture(scope="module")
def three_gate(setup):
    program = Program(THREE_GATE, 8, device="cpu")
    vk = setup.verification_key(program.common_preprocessed_input())
    prover = Prover(setup, program, debug=True, device="cpu")
    return prover, vk, prover.prove(dict(ASSIGNMENTS))


@pytest.fixture(scope="module")
def recorded_proof():
    return load_proof_pickle(os.path.join(FIXTURES, "proof.pickle"))


def test_recorded_proof_verifies(three_gate, recorded_proof):
    _, vk, _ = three_gate
    assert vk.verify_proof_unoptimized(8, recorded_proof, [60])
    assert vk.verify_proof(8, recorded_proof, [60])
    assert not vk.verify_proof(8, recorded_proof, [61])


def test_prover_bit_identical_to_reference(three_gate, recorded_proof):
    _, _, proof = three_gate
    ours, theirs = proof.flatten(), recorded_proof.flatten()
    assert set(ours) == set(theirs)
    for key in ours:
        assert ours[key] == theirs[key], f"proof field {key} diverges"


def test_prove_and_verify_roundtrip(three_gate):
    _, vk, proof = three_gate
    assert vk.verify_proof_unoptimized(8, proof, [60])
    assert vk.verify_proof(8, proof, [60])


def test_tampered_proof_rejected(three_gate):
    """A commitment swapped for another valid point fails the pairing; a
    malformed one fails validation before any pairing."""
    _, vk, proof = three_gate
    m1 = proof.msg_1
    swapped = type(proof)(Message1(m1.b_1, m1.a_1, m1.c_1), *(
        proof.msg_2, proof.msg_3, proof.msg_4, proof.msg_5))
    assert not vk.verify_proof(8, swapped, [60])
    broken = type(proof)(Message1(None, m1.b_1, m1.c_1), *(
        proof.msg_2, proof.msg_3, proof.msg_4, proof.msg_5))
    assert not vk.verify_proof(8, broken, [60])
    assert not vk.verify_proof_unoptimized(8, broken, [60])


def test_round_timings_and_trace_capture(three_gate, tmp_path):
    """The prover's Timings holds one section per round and one for round
    1's host encode of the witness; annotate's range lands in the
    torch.profiler trace that capture writes."""
    from plonkathon_tpu_torch.utils.profiling import annotate, capture

    prover, _, _ = three_gate
    summary = prover.timings.summary()
    assert set(summary) == {f"round_{i}" for i in range(1, 6)} | {"round_1_witness_host"}
    assert all(s["calls"] == 1 for s in summary.values())
    path = tmp_path / "trace.json"
    with capture(str(path)):
        with annotate("port_range"):
            torch.ones(4).sum()
    assert "port_range" in path.read_text()


@pytest.mark.slow
def test_both_provers_agree_on_factorization():
    from plonkathon_tpu.frontend import Program as JProgram
    from plonkathon_tpu.kzg import Setup as JSetup
    from plonkathon_tpu.prover import Prover as JProver

    program = Program.from_str(FACTOR_SRC, 16, device="cpu")
    assignments = program.fill_variable_assignments(dict(FACTOR_BITS))
    ours = Prover(Setup.from_file(PTAU, device="cpu"), program, device="cpu").prove(
        dict(assignments)
    ).flatten()
    jprogram = JProgram.from_str(FACTOR_SRC, 16)
    theirs = JProver(JSetup.from_file(PTAU), jprogram).prove(dict(assignments)).flatten()
    assert set(ours) == set(theirs)
    for key in ours:  # the two packages' field classes differ: compare ints
        assert _ints(ours[key]) == _ints(theirs[key]), f"proof field {key} diverges"


def _ints(v):
    return tuple(int(c) for c in v) if isinstance(v, tuple) else int(v)
