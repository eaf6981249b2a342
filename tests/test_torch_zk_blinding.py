"""ZK blinding through the port (CPU): the JAX package's
tests/test_zk_blinding.py on `device="cpu"`.

Wires hide through random values in the reserved last `blinding_rows`
rows (no constraints, identity sigma); Z, and with lookups f, h1, h2 and
Z2, through Z_H-multiples with fresh per-proof coefficients, which also
randomize their openings.  Proofs are made with the prover's debug checks
on.  Where the reference's file differs: its batch-prover refusal is
tests/test_torch_batch.py's (the port's BatchProver); the JAX package's
host verifier accepting blinded proofs is tests/test_torch_extensions.py's;
a slow test in tests/test_torch_zk_jax.py holds the port's blinded proofs
field for field against the JAX prover's under one seeded blinder stream.
"""

import os

import pytest
import torch

from plonkathon_tpu_torch import Fr, Program, Prover, Setup
from plonkathon_tpu_torch import transcript as T

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")
THREE_GATE = ["e public", "c <== a * b", "e <== c * d"]
ASSIGNMENTS = {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}
LOOKUP_TABLE = list(range(8))
LOOKUP_LINES = [
    "out public",
    "x lookup",
    "y lookup",
    "s <== x + y",
    "out <== s * s",
]


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


def _pin_challenges(monkeypatch, lookups=False):
    """Every Fiat-Shamir challenge of the port's transcript set to a
    constant, as the reference's tests pin theirs."""
    monkeypatch.setattr(T.Transcript, "round_1", lambda s, m: (Fr(7), Fr(13)))
    monkeypatch.setattr(T.Transcript, "round_2", lambda s, m: (Fr(17), Fr(23)))
    monkeypatch.setattr(T.Transcript, "round_3", lambda s, m: Fr(29))
    monkeypatch.setattr(T.Transcript, "round_4", lambda s, m: Fr(31))
    if lookups:
        # delta/epsilon are read off the transcript object in lookup mode.
        monkeypatch.setattr(T.Transcript, "delta", Fr(37), raising=False)
        monkeypatch.setattr(T.Transcript, "epsilon", Fr(41), raising=False)


def _two_proofs(setup, program, witness):
    prover = Prover(setup, program, debug=True, device="cpu")
    return prover.prove(dict(witness)).flatten(), prover.prove(dict(witness)).flatten()


def test_blinded_proofs_verify_and_differ(setup):
    program = Program(THREE_GATE, 8, blinding_rows=4, device="cpu")
    vk = setup.verification_key(program.common_preprocessed_input())
    prover = Prover(setup, program, debug=True, device="cpu")
    p1 = prover.prove(dict(ASSIGNMENTS))
    p2 = prover.prove(dict(ASSIGNMENTS))
    assert vk.verify_proof(8, p1, [60])
    assert vk.verify_proof_unoptimized(8, p2, [60])
    # Fresh randomness per proof: wire and grand-product commitments differ
    # between two proofs of the SAME witness.
    f1, f2 = p1.flatten(), p2.flatten()
    for key in ("a_1", "b_1", "c_1", "z_1"):
        assert f1[key] != f2[key], f"{key} not hidden"


def test_z_randomized_under_fixed_challenges(setup, monkeypatch):
    """The strong form of Z-hiding: with every challenge pinned, z_1 and
    z_shifted_eval still differ across proofs of the same witness (row-only
    blinding leaves Z a function of witness, beta and gamma)."""
    _pin_challenges(monkeypatch)
    program = Program(THREE_GATE, 8, blinding_rows=4, device="cpu")
    f1, f2 = _two_proofs(setup, program, ASSIGNMENTS)
    assert f1["z_1"] != f2["z_1"]
    assert f1["z_shifted_eval"] != f2["z_shifted_eval"]
    assert f1["a_1"] != f2["a_1"]


def test_blinding_rows_reduce_capacity():
    with pytest.raises(ValueError):
        Program(["x public"] + [f"c{i} <== a * a" for i in range(5)], 8,
                blinding_rows=3, device="cpu")


def test_blinded_sigma_is_identity_on_reserved_rows():
    program = Program(THREE_GATE, 8, blinding_rows=2, device="cpu")
    s1, s2, s3 = program.make_s_polynomials()
    roots = Fr.roots_of_unity(8)
    for row in (6, 7):
        assert Fr(s1.to_ints()[row]) == roots[row] * 1
        assert Fr(s2.to_ints()[row]) == roots[row] * 2
        assert Fr(s3.to_ints()[row]) == roots[row] * 3


def test_blinded_lookup_proof_verifies_and_hides(setup):
    """blinding_rows composes with PlonKup: the proof verifies on both
    verifier paths, and the lookup commitments are randomized."""
    program = Program(LOOKUP_LINES, 16, lookup_table=LOOKUP_TABLE,
                      blinding_rows=4, device="cpu")
    vk = setup.verification_key(program.common_preprocessed_input())
    prover = Prover(setup, program, debug=True, device="cpu")
    witness = program.fill_variable_assignments({"x": 3, "y": 5})
    p1 = prover.prove(dict(witness))
    p2 = prover.prove(dict(witness))
    assert vk.verify_proof(16, p1, [64])
    assert vk.verify_proof_unoptimized(16, p2, [64])
    f1, f2 = p1.flatten(), p2.flatten()
    for key in ("a_1", "z_1", "f_1", "h1_1", "h2_1", "z2_1"):
        assert f1[key] != f2[key], f"{key} not hidden"


def test_lookup_polys_randomized_under_fixed_challenges(setup, monkeypatch):
    """Strong-form hiding for the lookup stack: with every challenge pinned,
    the f/h1/h2/Z2 commitments AND the published openings still differ
    across two proofs of the same witness."""
    _pin_challenges(monkeypatch, lookups=True)
    program = Program(LOOKUP_LINES, 16, lookup_table=LOOKUP_TABLE,
                      blinding_rows=4, device="cpu")
    f1, f2 = _two_proofs(setup, program, program.fill_variable_assignments({"x": 3, "y": 5}))
    for key in ("f_1", "h1_1", "h2_1", "z2_1", "z_1"):
        assert f1[key] != f2[key], f"{key} not hidden under fixed challenges"
    for key in ("lk_f_eval", "lk_h1_eval", "lk_h2_eval", "lk_z2_w_eval",
                "z_shifted_eval"):
        assert f1[key] != f2[key], f"{key} leaks under fixed challenges"
