"""Round 1's witness columns (`Prover._witness_columns`): the host encodes
each distinct witness value once and the device gathers A, B, C and
writes PI.  Held against the host formula the prover used before, written
out here: `encode_ints` of `int(v) % p` over the variables in order of
first appearance (the None wire 0), a numpy gather over the wire plan, the
blinding tails on the last t rows, PI's `-x mod p` Montgomery limbs on the
public rows, then one `fr.to_mont` over the raw stack.  Witness values
cover >= p, negative ints and `Fr` objects; circuits two public inputs,
None wires, blinding rows (one seeded `secrets.randbelow` stream for both
sides) and lookups; batches of 1 and 3.  The caller's witness dicts are
only read.

Three tests, so the file sits at the tail of the Tier-1 queue
(tests/test_torch_build.py); the last runs on a card only, at 2^12:

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" -m cuda tests/test_torch_witness_upload.py
"""

import copy
import os
import random
import secrets

import numpy as np
import pytest
import torch

from plonkathon_tpu_torch import Fr, Program, Prover, Setup, load_proof_pickle
from plonkathon_tpu_torch.fields import FR_MOD
from plonkathon_tpu_torch.ops.limbs import NLIMBS, encode_ints, fr
from plonkathon_tpu_torch.parallel.batch import BatchProver

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")
THREE_GATE = ["e public", "c <== a * b", "e <== c * d"]
TWO_PUBLIC = ["e public", "a public", "c <== a * b", "e <== c * d"]
# The fixture witness {a: 3, b: 4, c: 12, d: 5, e: 60} in other forms.
ODD = {"a": Fr(3), "b": 4 + FR_MOD, "c": 12 - 2 * FR_MOD, "d": 5, "e": 60 + 3 * FR_MOD}
LOOKUP_LINES = ["out public", "x lookup", "y lookup", "s <== x + y", "out <== s * s"]


def _seeded(monkeypatch, seed):
    stream = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda bound: stream.randrange(bound))


def _oracle(prover, witnesses, seed):
    """The columns and PI the host formula gives, on the CPU."""
    program, n = prover.program, prover.group_order
    t = program.blinding_rows
    stream = random.Random(seed)
    wires = program.wires()
    ids = {}
    for w in wires:
        for v in (w.L, w.R, w.O):
            ids.setdefault(v, len(ids))
    plan = np.array([[ids[getattr(w, c)] for w in wires] for c in "LRO"], dtype=np.int64)
    public = program.get_public_assignments()
    cols, pis = [], []
    for wit in witnesses:
        tails = [[stream.randrange(FR_MOD) for _ in range(t)] for _ in range(3)]
        limbs = encode_ints([0 if v is None else int(wit[v]) % FR_MOD for v in ids])
        raw = np.zeros((NLIMBS, 3, n), dtype=np.int32)
        raw[:, :, : plan.shape[1]] = limbs[:, plan]
        for j in range(t and 3):
            raw[:, j, n - t :] = encode_ints(tails[j])
        if prover._lookup:
            raw = np.concatenate([raw, prover._lookup_columns(wit)], axis=1)
        cols.append(raw)
        pi = np.zeros((NLIMBS, n), dtype=np.int32)
        if public:
            pi[:, : len(public)] = fr.to_mont_host_many([(-int(wit[v])) % FR_MOD for v in public])
        pis.append(pi)
    return fr.to_mont(torch.from_numpy(np.stack(cols, axis=1))), torch.from_numpy(np.stack(pis, axis=1))


def _assert_parity(monkeypatch, prover, witnesses, seed):
    before = copy.deepcopy(witnesses)
    _seeded(monkeypatch, seed)
    cols, pi = prover._witness_columns(witnesses)
    want_cols, want_pi = _oracle(prover, witnesses, seed)
    assert torch.equal(cols.cpu(), want_cols)
    assert torch.equal(pi.cpu(), want_pi)
    assert witnesses == before


def _vanilla_cases(odd):
    """(program options, witnesses): plain and blinded, B = 1 and 3."""
    negative = {v: -(i + 7) for i, v in enumerate(odd)}
    large = {v: FR_MOD + i for i, v in enumerate(odd)}
    return [({}, [odd]), ({}, [odd, negative, odd]),
            ({"blinding_rows": 3}, [odd]), ({"blinding_rows": 3}, [odd, odd, large])]


def _lookup_parity(monkeypatch, setup, n, device, options):
    """LOOKUP_LINES at group order n, B = 1 and 3, for each set of options."""
    for opts in options:
        program = Program(LOOKUP_LINES, n, lookup_table=list(range(8)), device=device, **opts)
        lk = program.fill_variable_assignments({"x": 3, "y": 5})
        odd = dict(lk, x=lk["x"] + FR_MOD, s=Fr(lk["s"]), out=lk["out"] - FR_MOD)
        prover = Prover(setup, program, device=device)
        for seed, witnesses in enumerate(([odd], [odd, lk, odd])):
            _assert_parity(monkeypatch, prover, witnesses, 10 + seed)


@pytest.fixture(scope="module")
def setup():
    return Setup.from_file(PTAU, device="cpu")


def test_witness_columns_match_the_host_formula(setup, monkeypatch):
    for seed, (opts, witnesses) in enumerate(_vanilla_cases(ODD)):
        prover = Prover(setup, Program(TWO_PUBLIC, 16, device="cpu", **opts), device="cpu")
        _assert_parity(monkeypatch, prover, witnesses, seed)
    _lookup_parity(monkeypatch, setup, 16, "cpu", ({}, {"blinding_rows": 2}))


def test_prove_reads_the_witness_and_times_its_encode(setup):
    """The fixture proof from a witness of Fr objects, values >= p and
    negative values; the dicts are the same objects, unchanged, after
    `prove` and `prove_batch`; every proof's round 1 has its host
    encode section."""
    program = Program(THREE_GATE, 8, device="cpu")
    odd = dict(ODD, d=5 - FR_MOD)
    other = {"a": 2, "b": 5, "c": 10, "d": 7, "e": 70}
    before = copy.deepcopy([odd, other])
    fixture = load_proof_pickle(os.path.join(FIXTURES, "proof.pickle")).flatten()
    prover = Prover(setup, program, device="cpu")
    assert prover.prove(odd).flatten() == fixture
    batch = BatchProver(setup, program)
    proofs = batch.prove_batch([odd, other, odd])
    assert [p.flatten() for p in proofs[::2]] == [fixture, fixture]
    assert [odd, other] == before and None not in odd and None not in other
    for timings in (prover.timings, batch._prover.timings):
        assert timings.counts["round_1_witness_host"] == timings.counts["round_1"] == 1


@pytest.mark.cuda
def test_witness_columns_on_the_card(monkeypatch):
    """The parity cases at 2^12 on the card: a mul chain with its input and
    output public, blinded and not, and a lookup circuit, B = 1 and 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; on the chip run the command in this file's docstring")
    n, rows = 1 << 12, (1 << 12) - 8
    setup = Setup.generate(n + 3, device="cuda")
    lines = ["out public", "a public", "c1 <== a * a"] + [f"c{i} <== c{i-1} * a" for i in range(2, rows)]
    lines.append(f"out <== c{rows - 1} * a")
    chain = {"a": Fr(3), "out": -1}
    chain.update({f"c{i}": (i - 40) * (FR_MOD + 1) for i in range(1, rows)})
    for seed, (opts, witnesses) in enumerate(_vanilla_cases(chain)):
        prover = Prover(setup, Program(lines, n, device="cuda", **opts), device="cuda")
        _assert_parity(monkeypatch, prover, witnesses, seed)
    _lookup_parity(monkeypatch, setup, n, "cuda", ({},))
