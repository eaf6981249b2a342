"""The comparison that decides `correct`.

The proofs a run returned are handed over as plain integers and judged by
the plain reference (reference/plonk.py), which builds the circuit from the
same lines and inputs and uses the SRS trapdoor tau the seed drew.  Every
number compared is an exact count, and its limit is 0: a proof either
holds the protocol's values or it does not."""

from __future__ import annotations

import importlib
import multiprocessing

from .reference.plonk import Checker, Circuit

LIMITS = {
    "proofs_missing": 0,    # proofs asked for and not returned, or returned beyond the count asked
    "commits_wrong": 0,     # a, b, c, z (and f, h1, h2, z2) not p(tau) G
    "quotient_wrong": 0,    # t_lo + tau^n t_mid + tau^2n t_hi not t(tau) G
    "evals_wrong": 0,       # round 4's openings not the reference's evaluations
    "openings_wrong": 0,    # W_zeta, W_zeta_omega not the reference's
}

_checker = None
_inputs = None


def proof_ints(proof) -> dict:
    """A program proof's flattened fields as plain ints: points (x, y) or
    None, scalars int."""
    out = {}
    for key, value in proof.flatten().items():
        if value is None:
            out[key] = None
        elif isinstance(value, tuple):
            out[key] = (int(value[0]), int(value[1]))
        else:
            out[key] = int(value)
    return out


def _init(family: str, cfg: dict, tau: int, inputs: list):
    global _checker, _inputs
    fam = importlib.import_module(f"benchmark.families.{family}")
    circuit = Circuit(fam.lines(cfg), cfg["group_order"], table=fam.table(cfg))
    _checker, _inputs = Checker(circuit, tau), inputs


def _check(item):
    index, proof = item
    return _checker.check(proof, _inputs[index])


def judge(family: str, cfg: dict, tau: int, inputs: list, answers: list, workers: int) -> dict:
    """Sums of the reference's counts over `answers`, a list of (pool
    index, proof as ints).  `workers` > 1 spreads the proofs over that many
    spawned processes (each builds the circuit once); they are joined
    before this returns."""
    totals = {k: 0 for k in LIMITS if k != "proofs_missing"}
    if not answers:
        return totals
    workers = max(1, min(workers, len(answers)))
    if workers == 1:
        _init(family, cfg, tau, inputs)
        results = [_check(a) for a in answers]
    else:
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(workers, initializer=_init, initargs=(family, cfg, tau, inputs))
        try:
            results = pool.map(_check, answers, chunksize=1)
        finally:
            pool.close()
            pool.join()
    for r in results:
        for k, v in r.items():
            totals[k] += v
    return totals
