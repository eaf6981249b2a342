"""The port's BatchProver (CPU): B proofs of one circuit per call, each
equal field for field to the single prover's proof of its witness; the
JAX package's tests/test_batch.py and test_zk_blinding.py's
batch-refuses-blinding case, with the port's refusals of lookups and of a
mesh that is not the port's Mesh (tests/test_torch_sharded.py
shards a batch over a mesh).
"""

import os

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup, load_proof_pickle
from plonkathon_tpu_torch.parallel.batch import BatchProver

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")
THREE_GATE = ["e public", "c <== a * b", "e <== c * d"]
WITNESSES = [
    {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60},
    {"a": 2, "b": 5, "c": 10, "d": 7, "e": 70},
]


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


def test_batch_prover_rejects_blinding(setup):
    program = Program(THREE_GATE, 8, blinding_rows=2, device="cpu")
    with pytest.raises(ValueError, match="blinding"):
        BatchProver(setup, program)


def test_batch_prover_rejects_lookups(setup):
    program = Program(["x lookup", "y <== x * x"], 8, lookup_table=[0, 1, 2], device="cpu")
    with pytest.raises(ValueError, match="lookup"):
        BatchProver(setup, program)


def test_batch_prover_mesh_must_be_a_mesh(setup):
    program = Program(THREE_GATE, 8, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        BatchProver(setup, program, mesh=object())


def test_batch_prover_matches_single(setup):
    program = Program(THREE_GATE, 8, device="cpu")
    proofs = BatchProver(setup, program).prove_batch([dict(w) for w in WITNESSES])
    assert len(proofs) == 2
    # Proof 0 is the fixture proof (the single prover reproduces it too);
    # proof 1 equals the single prover's proof of its witness, which
    # verifies.
    fixture = load_proof_pickle(os.path.join(FIXTURES, "proof.pickle")).flatten()
    assert proofs[0].flatten() == fixture
    single = Prover(setup, program, device="cpu").prove(dict(WITNESSES[1])).flatten()
    ours = proofs[1].flatten()
    assert set(ours) == set(single)
    for key in ours:
        assert ours[key] == single[key], f"batch/single divergence at {key}"
    vk = setup.verification_key(program.common_preprocessed_input())
    assert vk.verify_proof(8, proofs[1], [70])
