#!/usr/bin/env python3
"""The length-sharded mul-chain over NCCL, one rank per visible card.

Run from the repository root on a host with D cards:

    python3 scripts/sharded_nccl.py [log2 n]      # n = 2^18 by default

This process (rank 0) builds the kernels, makes Setup.generate(n) and
proves the mul-chain on its card as the reference, then runs
chip_smoke.py's phase 13(a) with one rank per visible card (ranks 1 ... D - 1
spawned, each with its own Setup.generate(n)): the sharded cold and warm
proofs must equal the reference field for field, every rank must launch
the phase's kernels, and the collectives are counted.  Prints the cards'
name and power limit, the reference proof's walls and phase 13(a)'s line;
exits non-zero on any failure.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import plonkathon_tpu_torch as ptt
    from plonkathon_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs CUDA cards")
    n = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 18)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    print(f"{torch.cuda.device_count()} card(s); torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    cuda_lib.build()
    setup = ptt.Setup.generate(n, tau=cs.TAU)
    program = ptt.Program(cs.chain_lines(n), n)
    witness = cs.chain_witness(n, 3)
    reference = ptt.Prover(setup, program)
    t1 = time.perf_counter()
    reference.prove(dict(witness))
    cold = time.perf_counter() - t1
    t1 = time.perf_counter()
    want = reference.prove(dict(witness))
    warm = time.perf_counter() - t1
    print(f"reference: the mul-chain n = {n} on one card, cold {cold:.3f} s, warm "
          f"{warm:.3f} s (build, setup and Prover() {t1 - t0 - cold:.1f} s)", flush=True)
    cs.sharded_nccl_phase(ptt, torch, cuda_lib, setup, program, witness, want)


if __name__ == "__main__":
    main()
