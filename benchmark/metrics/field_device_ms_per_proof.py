"""Device time of the field algebra in the traced stretch, per proof: the
Montgomery-product kernel (K1) and every kernel not built from the program's csrc/
(torch's elementwise ops)."""

def read(run):
    tr = run.trace
    if tr is None or not run.traced_proofs:
        return None
    us = sum(e - s for name, s, e in tr.kernels
             if name == "k1_kernel" or name.startswith("torch:"))
    return us / 1e3 / run.traced_proofs if us else None
