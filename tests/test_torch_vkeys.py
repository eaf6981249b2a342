"""The port's commitments against the JAX package's pinned fixtures (CPU):
the golden commitment and the three snarkjs verification keys
(tests/test_e2e.py:35-67), on the ceremony SRS, and the key of a vanilla
circuit without the extensions' commitments (tests/test_torch_custom_gates.py's
VANILLA_LINES); and the factorization circuit of tests/test_torch_e2e.py at
n = 16 proved and verified on it."""

import json
import os

import pytest
import torch

from plonkathon_tpu_torch import Basis, Polynomial, Program, Prover, Setup, interpret_json_point
from plonkathon_tpu_torch.fields import Fq

from test_torch_custom_gates import VANILLA_LINES
from test_torch_e2e import FACTOR_BITS, FACTOR_SRC

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


def test_setup_golden_commitment(setup):
    dummy = Polynomial(list(range(1, 9)), Basis.LAGRANGE, device="cpu")
    assert setup.commit(dummy) == (
        Fq(16120260411117808045030798560855586501988622612038310041007562782458075125622),
        Fq(3125847109934958347271782137825877642397632921923926105820408033549219695465),
    )
    # Monomial input commits the same coefficients without an NTT.
    assert setup.commit(dummy.ifft()) == setup.commit(dummy)


VKEY_CASES = [
    (["c <== a * b"], "main.plonk.vkey.json"),
    (["ab === a - c", "-ab === a * b"], "main.plonk.vkey-58.json"),
    (["c public", "c === a * b"], "main.plonk.vkey-59.json"),
]


@pytest.mark.parametrize("lines,fixture", VKEY_CASES, ids=[c[1] for c in VKEY_CASES])
def test_vkey_matches_snarkjs(setup, lines, fixture):
    program = Program(lines, 8, device="cpu")
    vk = setup.verification_key(program.common_preprocessed_input())
    with open(os.path.join(FIXTURES, fixture)) as f:
        theirs = json.load(f)
    for key in ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3", "X_2"):
        assert interpret_json_point(theirs[key]) == getattr(vk, key), key
    assert vk.w == int(theirs["w"])
    assert vk.w == 19540430494807482326159819597004422086093766032135589407132600596362845576832


def test_vanilla_vk_has_no_qcube(setup):
    program = Program(VANILLA_LINES, 8, device="cpu")
    vk_v = setup.verification_key(program.common_preprocessed_input())
    assert vk_v.Qcube is None and vk_v.Qk is None and vk_v.Tbl is None


def test_factorization_circuit(setup):
    program = Program.from_str(FACTOR_SRC, 16, device="cpu")
    assignments = program.fill_variable_assignments(dict(FACTOR_BITS))
    vk = setup.verification_key(program.common_preprocessed_input())
    proof = Prover(setup, program, device="cpu").prove(assignments)
    assert vk.verify_proof(16, proof, [91])
