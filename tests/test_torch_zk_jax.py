"""The port's blinded proofs and standalone plookup against the JAX
package's, field for field (slow: these compile the JAX prover's round
kernels and its CPU MSM, minutes of XLA:CPU).

ZK blinding draws its blinders through `secrets.randbelow` in both
packages, in the same order (the wire tails, 3 columns x t; with lookups
the f / h1 / h2 blinders, 2, 3 and 3; Z's 3; with lookups Z2's 3), so one
seeded stream patched into `secrets.randbelow` for each prover makes their
proofs equal, field for field, for the vanilla, cube-gate and lookup
circuits.  Plookup has no randomness: the port's proof at n = 8 equals the
JAX package's `prove_lookup`.
"""

import os
import random
import secrets

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup

from _torch_jax_bridge import ints

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")

CIRCUITS = {
    "vanilla": (["e public", "c <== a * b", "e <== c * d"], 8,
                dict(blinding_rows=4), {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}),
    "cube": (["y <== x * x * x", "z <== y * x"], 8,
             dict(blinding_rows=3, custom_gates=True), {"x": 3}),
    "lookup": (["out public", "x lookup", "y lookup", "s <== x + y", "out <== s * s"], 16,
               dict(blinding_rows=4, lookup_table=list(range(8))), {"x": 3, "y": 5}),
}


def _seeded(monkeypatch, seed):
    stream = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda bound: stream.randrange(bound))


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_blinded_proof_equals_jax_under_one_stream(monkeypatch, name):
    from plonkathon_tpu.frontend import Program as JaxProgram
    from plonkathon_tpu.kzg import Setup as JaxSetup
    from plonkathon_tpu.prover import Prover as JaxProver

    lines, n, kwargs, inputs = CIRCUITS[name]
    program = Program(lines, n, device="cpu", **kwargs)
    witness = program.fill_variable_assignments(inputs)
    _seeded(monkeypatch, 20261017)
    ours = Prover(Setup.from_file(PTAU, device="cpu"), program, debug=True,
                  device="cpu").prove(dict(witness)).flatten()
    _seeded(monkeypatch, 20261017)
    theirs = JaxProver(JaxSetup.from_file(PTAU), JaxProgram(lines, n, **kwargs)).prove(
        dict(witness)).flatten()
    assert set(ours) == set(theirs)
    for key in ours:
        assert ints(ours[key]) == ints(theirs[key]), f"proof field {key} diverges"
    # Another stream, another proof.
    _seeded(monkeypatch, 7)
    other = Prover(Setup.from_file(PTAU, device="cpu"), program, device="cpu").prove(
        dict(witness)).flatten()
    assert other["z_1"] != ours["z_1"]


@pytest.mark.slow
def test_lookup_proof_equals_jax():
    from plonkathon_tpu.kzg import Setup as JaxSetup
    from plonkathon_tpu.lookup import prove_lookup as jax_prove_lookup
    from plonkathon_tpu_torch.lookup import prove_lookup

    table, witness = [1, 5, 7, 11, 13, 17, 19, 23], [5, 13, 1, 5, 23, 7, 7]
    ours = prove_lookup(Setup.from_file(PTAU, device="cpu"), table, witness)
    theirs = jax_prove_lookup(JaxSetup.from_file(PTAU), table, witness)
    for key in ("f_1", "h1_1", "h2_1", "z_1", "q_1", "W_z_1", "W_zw_1"):
        assert ints(getattr(ours, key)) == ints(getattr(theirs, key)), key
    assert ours.evals == {k: int(v) for k, v in theirs.evals.items()}
