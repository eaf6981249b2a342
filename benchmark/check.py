"""The comparison that decides `correct`.

The proofs a run returned are handed over as plain integers and judged by
the judge module that the configuration's `reference` names, a file under
`benchmark/` (both present configurations name reference/plonk.py).  The
judge builds the circuit from the same lines and inputs and uses the SRS
trapdoor tau the seed drew.  Every number compared is an exact count, and
its limit is 0: a proof either holds the protocol's values or it does not.

A judge module declares:

* `LIMITS`: each count it returns, in the order the result line lists
  them, with its limit;
* `checker(lines, cfg, table, tau)`: an object whose `check(proof,
  inputs)` returns its counts for one proof (the circuit's lines and table
  from the configuration's family, `cfg` the configuration's file);
* optionally `across(answers, inputs)`: counts over every proof of the
  window, a list of (pool index, proof as ints), for what no single proof
  shows (a blinder reused across proofs of one witness).  It runs in the
  parent process.

`proofs_missing` and `proofs_checked` are the harness's own counts."""

from __future__ import annotations

import gc
import importlib
import multiprocessing
import os
from multiprocessing import resource_tracker

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


def reference(cfg: dict):
    """The judge module the configuration's `reference` names, imported by
    its dotted name in the `benchmark` package (so that its relative
    imports hold in spawned workers).  A path that is not a .py file under
    benchmark/ is refused."""
    rel = cfg["reference"]
    parts = rel.removesuffix(".py").split("/")
    if not rel.endswith(".py") or parts[0] != "benchmark" or len(parts) < 2 \
            or not all(p.isidentifier() for p in parts):
        raise SystemExit(f"reference {rel!r}: not a .py file under benchmark/")
    return importlib.import_module(".".join(parts))


def limits(cfg: dict) -> dict:
    """Every count compared but `proofs_checked`, in order, with its limit."""
    return {
        "proofs_missing": 0,  # proofs asked for and not returned, or returned beyond the count asked
        **reference(cfg).LIMITS,
    }


def _init(cfg: dict, tau: int, inputs: list):
    global _checker, _inputs
    fam = importlib.import_module(f"benchmark.families.{cfg['family']}")
    _checker = reference(cfg).checker(fam.lines(cfg), cfg, fam.table(cfg), tau)
    _inputs = inputs


def _check(item):
    index, proof = item
    return _checker.check(proof, _inputs[index])


def _stop_resource_tracker():
    """Ends the resource tracker that a spawned pool starts, and waits for
    it: some Python 3.12 releases leave it to end after the process.  The
    pool's semaphores are collected first, so none calls it up again."""
    gc.collect()
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is None or tracker._fd is None:
        return
    os.close(tracker._fd)  # the tracker ends when it reads the end of this pipe
    tracker._fd = None
    os.waitpid(tracker._pid, 0)
    tracker._pid = None


def judge(cfg: dict, tau: int, inputs: list, sample: list, answers: list, workers: int) -> dict:
    """The judge's counts: its `check` summed over `sample`, and its
    `across` over `answers`; both lists of (pool index, proof as ints).
    `workers` > 1 spreads the sample over that many spawned processes
    (each builds the judge once); they and the pool's resource tracker
    have ended before this returns."""
    module = reference(cfg)
    totals = dict.fromkeys(module.LIMITS, 0)
    results = []
    workers = max(1, min(workers, len(sample)))
    if sample and workers == 1:
        _init(cfg, tau, inputs)
        results = [_check(a) for a in sample]
    elif sample:
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(workers, initializer=_init, initargs=(cfg, tau, inputs))
        try:
            results = pool.map(_check, sample, chunksize=1)
        finally:
            pool.close()
            pool.join()
            del pool
            _stop_resource_tracker()
    if hasattr(module, "across"):
        results.append(module.across(answers, inputs))
    for r in results:
        for k, v in r.items():
            totals[k] += v  # a count the judge's LIMITS lacks raises here
    return totals
