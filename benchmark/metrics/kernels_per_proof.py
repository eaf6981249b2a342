"""Device kernels in the traced stretch, torch's own included, per proof."""

def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not run.traced_proofs:
        return None
    return len(tr.kernels) / run.traced_proofs
