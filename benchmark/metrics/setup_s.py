"""From process start to the first timed request: imports, CUDA, the kernels' library,
Setup.generate, Program, the witness pool, the prover and the two warm-up requests."""

def read(run):
    return run.setup_s or None
