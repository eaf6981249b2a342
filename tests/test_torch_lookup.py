"""The standalone plookup argument through the port (CPU): the JAX
package's tests/test_lookup.py on `device="cpu"`, and the JAX package's
`verify_lookup` accepting the port's proof.

The table commitment the JAX verifier is handed is computed by the JAX
package's host curve code (`ec_lincomb` over the SRS powers, by integer
coordinates), independent of the port's MSM.  A slow test in
tests/test_torch_zk_jax.py holds the port's proof field for field against
the JAX package's `prove_lookup` (plookup has no randomness).
"""

import os

import pytest
import torch

from plonkathon_tpu_torch import Fr, Setup
from plonkathon_tpu_torch.lookup import (
    LookupProof,
    _sorted_by_table,
    prove_lookup,
    verify_lookup,
)

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")

TABLE = [1, 5, 7, 11, 13, 17, 19, 23]  # n = 8
WITNESS = [5, 13, 1, 5, 23, 7, 7]  # n - 1 = 7 values, all in table


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


@pytest.fixture(scope="module")
def proof(setup):
    return prove_lookup(setup, TABLE, WITNESS)


def test_sorted_by_table_is_valid_merge():
    f = [5, 5, 13, 1]
    s = _sorted_by_table(f, TABLE)
    assert len(s) == len(TABLE) + len(f)
    assert sorted(s) == sorted(TABLE + f)
    # order respects the table's order
    pos = {v: i for i, v in enumerate(TABLE)}
    assert all(pos[s[i]] <= pos[s[i + 1]] for i in range(len(s) - 1))


def test_lookup_prove_verify(setup, proof):
    assert verify_lookup(setup, TABLE, proof)


def test_lookup_rejects_outside_value(setup):
    with pytest.raises(AssertionError):
        prove_lookup(setup, TABLE, [5, 13, 4, 5, 23, 7, 7])  # 4 not in table


def test_lookup_rejects_tampered_eval(setup, proof):
    bad = LookupProof(
        proof.f_1, proof.h1_1, proof.h2_1, proof.z_1, proof.q_1,
        dict(proof.evals), proof.W_z_1, proof.W_zw_1,
    )
    bad.evals["f"] = (bad.evals["f"] + 1) % Fr.modulus
    assert verify_lookup(setup, TABLE, bad) is False


def test_lookup_rejects_tampered_opening(setup, proof):
    from plonkathon_tpu_torch.ec import pt_add

    bad = LookupProof(
        proof.f_1, proof.h1_1, proof.h2_1, proof.z_1, proof.q_1,
        dict(proof.evals), pt_add(proof.W_z_1, proof.W_z_1), proof.W_zw_1,
    )
    assert verify_lookup(setup, TABLE, bad) is False


def test_jax_verify_lookup_accepts_port_proof(setup, proof):
    from plonkathon_tpu.ec import ec_lincomb
    from plonkathon_tpu.fields import Fr as JaxFr
    from plonkathon_tpu.kzg import Setup as JaxSetup
    from plonkathon_tpu.lookup import LookupProof as JaxLookupProof
    from plonkathon_tpu.lookup import verify_lookup as jax_verify_lookup
    from plonkathon_tpu_torch.poly import Basis, Polynomial

    from _torch_jax_bridge import jax_g1, jax_g2

    g1s = [jax_g1(p) for p in setup.powers_of_x]
    jax_setup = JaxSetup(g1s, jax_g2(setup.X2))
    # t_1 = [t(x)]_1 from the table's monomial coefficients, on the host.
    coeffs = Polynomial(TABLE, Basis.LAGRANGE, device="cpu").ifft().to_ints()
    t_1 = ec_lincomb([(p, JaxFr(c)) for p, c in zip(g1s, coeffs)])
    theirs = JaxLookupProof(
        *(jax_g1(getattr(proof, k)) for k in ("f_1", "h1_1", "h2_1", "z_1", "q_1")),
        dict(proof.evals), jax_g1(proof.W_z_1), jax_g1(proof.W_zw_1),
    )
    assert jax_verify_lookup(jax_setup, TABLE, theirs, t_1=t_1)
    bad = dict(proof.evals)
    bad["f"] = (bad["f"] + 1) % Fr.modulus
    theirs.evals = bad
    assert not jax_verify_lookup(jax_setup, TABLE, theirs, t_1=t_1)
