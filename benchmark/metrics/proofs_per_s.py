"""Proofs returned in the window over the window's measured span (a batch counts B)."""

def read(run):
    if not run.proofs or run.window_s <= 0:
        return None
    return run.proofs / run.window_s
