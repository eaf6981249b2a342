"""Prover.timings' `round_1_lookup_host` (PlonKup's f, h1, h2 built on the host) over
the window, per proof returned; nothing where the circuit has no lookups."""

def read(run):
    s = run.sections.get("round_1_lookup_host")
    return None if s is None or not run.proofs else s * 1e3 / run.proofs
