"""The port's public-input evaluation PI(zeta) and both of its verifiers
against the JAX package's, on the fixture proof (the circuit `e public`,
n = 8), at public-input lengths around n (CPU).

The reference evaluates PI over L = max(n, len(public)) points with the
generator 5^((r-1)//L), which is a root of unity only where L divides
r - 1 (not at 10 or 17), and sums the terms by pairwise halving. The JAX
verification key is built from the integer coordinates of the port's key,
so no JAX MSM is compiled; each new length compiles one small JAX
barycentric evaluation. The port's key is committed on the host (the
SRS points against the preprocessed coefficients), which skips the CPU
route's window tables; tests/test_torch_vkeys.py holds the port's
`Setup.verification_key` against snarkjs."""

import os

import pytest
import torch

from plonkathon_tpu.fields import Fr as JaxFr
from plonkathon_tpu.utils.serialization import load_proof_pickle as jax_load_proof
from plonkathon_tpu_torch import Program, Setup, load_proof_pickle
from plonkathon_tpu_torch.ec import ec_lincomb
from plonkathon_tpu_torch.fields import Fr
from plonkathon_tpu_torch.verifier import VerificationKey

from _torch_jax_bridge import G1_KEYS, jax_vk

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")
PROOF = os.path.join(FIXTURES, "proof.pickle")
N = 8
LENGTHS = [N - 1, N, N + 1, N + 2, 2 * N, 2 * N + 1]
ZETA = 0x2B3F6E1D9A7C5048112233445566778899AABBCCDDEEFF0011223344556677
VERIFIERS = ("verify_proof", "verify_proof_unoptimized")


@pytest.fixture(scope="module")
def keys():
    setup = Setup.from_file(PTAU, device="cpu")
    pk = Program(["e public", "c <== a * b", "e <== c * d"], N, device="cpu")
    pk = pk.common_preprocessed_input()
    srs = setup.powers_of_x[:N]
    vk = VerificationKey(
        N,
        *(
            ec_lincomb(list(zip(srs, getattr(pk, k.upper()).ifft().to_ints())))
            for k in G1_KEYS
        ),
        setup.X2,
        Fr.root_of_unity(N),
    )
    return vk, jax_vk(vk)


@pytest.fixture(scope="module")
def proofs():
    return load_proof_pickle(PROOF), jax_load_proof(PROOF)


def _publics(length):
    """The fixture's public input 60 followed by a zero tail, and the same
    list with its last entry made non-zero."""
    zero_tail = [60] + [0] * (length - 1)
    return zero_tail, zero_tail[:-1] + [5]


@pytest.mark.parametrize("length", LENGTHS)
def test_public_inputs_match_reference(keys, proofs, length):
    vk, ref_vk = keys
    proof, jax_proof = proofs
    results = []
    for public in _publics(length):
        pi = vk._common_evals(N, Fr(ZETA), public)[2]
        assert int(pi) == int(ref_vk._common_evals(N, JaxFr(ZETA), public)[2])
        expected = [getattr(ref_vk, f)(N, jax_proof, public) for f in VERIFIERS]
        got = [getattr(vk, f)(N, proof, public) for f in VERIFIERS]
        assert got == expected, (public, got, expected)
        results.append(got)
    # The proof's statement is [60]: a zero tail within n states it again,
    # a non-zero last entry states something else.
    if length <= N:
        assert results[0] == [True, True]
    assert results[1] == [False, False]
