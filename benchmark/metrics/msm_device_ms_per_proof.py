"""Device time of the commit kernels (msm3: K3, K4, the dense stage, the suffix fold;
msm2: K5, K6) in the traced stretch, per proof."""

MSM = {"k3_kernel", "k4_kernel", "k4_dense_kernel", "k5_kernel", "k5_fold_kernel", "k6_kernel"}


def read(run):
    tr = run.trace
    if tr is None or not run.traced_proofs:
        return None
    us = sum(e - s for name, s, e in tr.kernels if name in MSM)
    return us / 1e3 / run.traced_proofs if us else None
