"""The host span around Program(...) and Prover(...) or BatchProver(...) in set-up."""

def read(run):
    return run.spans.get("prover_init_s")
