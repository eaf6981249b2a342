"""Prover.timings' `round_3` over the window, per proof returned."""

def read(run):
    s = run.sections.get("round_3")
    return None if s is None or not run.proofs else s * 1e3 / run.proofs
