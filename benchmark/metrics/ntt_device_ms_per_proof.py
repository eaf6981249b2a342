"""Device time of the NTT butterfly kernel (K2) in the traced stretch, per proof."""

def read(run):
    tr = run.trace
    if tr is None or not run.traced_proofs:
        return None
    us = sum(e - s for name, s, e in tr.kernels if name == "k2_kernel")
    return us / 1e3 / run.traced_proofs if us else None
