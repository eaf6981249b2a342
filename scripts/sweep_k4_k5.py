#!/usr/bin/env python3
"""Launch configurations, compile times and SASS of the port's K4 and K5.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/sweep_k4_k5.py [--compile-only] [--parent-csrc DIR] [--json PATH]

It prints:
  1. each CUDA source of plonkathon_tpu_torch/csrc compiled alone (the
     flags of ops/cuda_lib.py), with its wall time and ptxas's stack frame,
     spills and registers for k4_kernel, k4_dense_kernel, k5_kernel and
     k5_fold_kernel (--compile-only stops here);
  2. each of those kernels built at each launch configuration below, every
     build compiled in parallel from a copy of the sources with the
     constants replaced, timed with CUDA events (mean of 20 launches after
     a warm-up) in two rounds, the second in reverse order, and held
     against the committed build's output (max abs err): K4's merge scan
     (S 16 x 2^14), K4's dense-bucket stage (2^15 buckets, J rounds), K5 at
     the msm2 fallback's widest chunk-fold level (2^21 lanes) and the whole
     msm3 suffix fold (2^15 buckets); `--parent-csrc` adds the merge scan
     and the 2^21 level of another csrc directory (say an earlier commit's,
     unpacked with `git archive`) to the same rounds;
  3. the SASS of the committed build (cuobjdump -sass): instructions of the
     four kernels by opcode class, local loads and stores among them.
It fails without a card or when a build's output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import shutil
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from sweep_k3_k7 import compile_copy, ptxas_report, sass_classes  # noqa: E402

CSRC = os.path.join(ROOT, "plonkathon_tpu_torch", "csrc")
KERNELS = ("k4_kernel", "k4_dense_kernel", "k5_kernel", "k5_fold_kernel")
# (tag, source, kernel, {constant: value}) for each configuration.
CONFIGS = (
    [(f"k4 merge {t}", "msm3.cu", "k4_kernel", {"kK4Threads": t}) for t in (32, 64, 128, 256)]
    + [(f"k4 dense {t}", "msm3.cu", "k4_dense_kernel", {"kDenseThreads": t})
       for t in (32, 64, 128, 256)]
    + [(f"k5 {t}x{m}", "msm.cu", "k5_kernel", {"kAddThreads": t, "kAddMinBlocks": m})
       for t, m in ((256, 2), (128, 4), (512, 1), (128, 3), (64, 8), (128, 1))]
    + [(f"k5 fold {t}", "msm.cu", "k5_fold_kernel", {"kFoldThreads": t}) for t in (128, 256)]
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compile-only", action="store_true", help="stop after part 1")
    ap.add_argument("--parent-csrc", help="another csrc directory to time beside")
    ap.add_argument("--json", help="write the rows to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_k4_k5: needs a CUDA card")
    import chip_smoke as cs
    from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm2, msm3

    nvcc = cuda_lib._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = list(cuda_lib.NVCC_FLAGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix="sweep_k4_k5_")
    try:
        # 1. each source alone
        with ThreadPoolExecutor(3) as ex:
            alone = list(ex.map(lambda s: compile_copy(work, nvcc, flags, f"alone_{s}", CSRC, s),
                                ("msm3.cu", "msm.cu", "mont.cu")))
        for b in alone:
            print(f"[1] {b['tag'][6:]} alone: rc {b['rc']}, {b['build_s']:.1f} s", flush=True)
            for kernel in KERNELS:
                if f"{len(kernel)}{kernel}" in b["log"]:
                    print(f"    {kernel}: {ptxas_report(b['log'], kernel)}", flush=True)
            if b["rc"]:
                raise SystemExit(b["log"][-4000:])
        if args.compile_only:
            return

        # 2. configurations, against the committed build
        cuda_lib.build()
        rng = np.random.default_rng(6)
        n = cs.HEADLINE_N
        _, _, _, t_ends, t_dense = msm3.plan_params(16 * n)
        w4 = t_ends // 16
        acc4, pts4, mask4 = cs._inc_case(torch, np, rng, "jadd", 16, w4, [0, 0, 0, 1])
        keys, _ = cs._dense_keys(np, rng, msm3._NB2, t_dense, msm3._J)
        keys = torch.from_numpy(keys).to("cuda")
        ptsd = cs._packed(torch, np, rng, 3, t_dense)
        w5 = msm2.NB * msm2._choose_chunks(32 * n) // 2
        pa, pb = cs._points(torch, np, rng, w5)
        dense = cs._bucket_multiples(torch, msm3._NB2)
        consts = CM.field_consts("fq")
        stream = torch.cuda.current_stream().cuda_stream
        P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        out4 = torch.empty((16, 24, w4), dtype=torch.int32, device="cuda")
        outd = torch.empty((48, msm3._NB2), dtype=torch.int32, device="cuda")
        mm = torch.zeros(1, dtype=torch.int32, device="cuda")
        out5 = torch.empty_like(pa)
        scratch = torch.empty((2, 48, msm3._NB2), dtype=torch.int32, device="cuda")
        outf = torch.empty(48, dtype=torch.int32, device="cuda")
        refs = {
            "k4_kernel": msm3._inc_scan("jadd", acc4, pts4, mask4),
            "k4_dense_kernel": msm3._dense_buckets(keys, ptsd, msm3._J)[0],
            "k5_kernel": msm2.jadd_stacked(pa, pb),
            "k5_fold_kernel": msm3.suffix_fold(dense),
        }

        def launcher(so, kernel):
            """(output tensor, launch) of `kernel`'s entry point in `so`."""
            if kernel == "k4_kernel":
                f = so.k4_jadd_packed
                f.argtypes = [P, P, P, P, I64, I64, P, P]
                return out4, lambda: f(acc4.data_ptr(), pts4.data_ptr(), mask4.data_ptr(),
                                       out4.data_ptr(), 16, w4, consts, stream)
            if kernel == "k4_dense_kernel":
                f = so.k4_dense_buckets
                f.argtypes = [P, P, P, P, I64, I64, I32, P, P]
                return outd, lambda: f(keys.data_ptr(), ptsd.data_ptr(), outd.data_ptr(),
                                       mm.data_ptr(), t_dense, msm3._NB2, msm3._J, consts,
                                       stream)
            if kernel == "k5_kernel":
                f = so.k5_jadd_stacked
                f.argtypes = [P, P, P, I64, P, P]
                return out5, lambda: f(pa.data_ptr(), pb.data_ptr(), out5.data_ptr(), w5,
                                       consts, stream)
            f = so.k5_suffix_fold
            f.argtypes = [P, P, P, I64, P, P]
            return outf, lambda: f(dense.data_ptr(), scratch.data_ptr(), outf.data_ptr(),
                                   msm3._NB2, consts, stream)

        jobs = [(tag, CSRC, src, kernel, consts_) for tag, src, kernel, consts_ in CONFIGS]
        if args.parent_csrc:
            jobs += [("k4 merge parent", args.parent_csrc, "msm3.cu", "k4_kernel", None),
                     ("k5 parent", args.parent_csrc, "msm.cu", "k5_kernel", None)]
        with ThreadPoolExecutor(8) as ex:
            builds = list(ex.map(
                lambda j: compile_copy(work, nvcc, flags, j[0].replace(" ", "_"), j[1], j[2], j[4]),
                jobs))
        rows = []
        order = list(zip(jobs, builds))
        for rnd in range(2):
            for job, b in (order if rnd == 0 else order[::-1]):
                tag, kernel = job[0], job[3]
                if b["rc"]:
                    raise SystemExit(f"{tag}: build failed\n{b['log'][-4000:]}")
                out, fn = launcher(ctypes.CDLL(b["so"]), kernel)
                rc = fn()
                torch.cuda.synchronize()
                if rc != 0:
                    raise SystemExit(f"{tag}: launch failed, cudaError {rc}")
                err = int((out.long() - refs[kernel].long()).abs().max())
                ms = cs._timed(torch, fn, 20)
                rows.append(dict(config=tag, round=rnd, ms=ms, max_abs_err=err,
                                 build_s=b["build_s"], ptxas=ptxas_report(b["log"], kernel)))
                print(f"[2] {tag:<16} round {rnd}: {ms:.4f} ms, max abs err {err}"
                      + (f", build {b['build_s']:.1f} s; {rows[-1]['ptxas']}" if rnd == 0 else ""),
                      flush=True)
                if err != 0:
                    raise SystemExit(f"{tag} differs from the committed build")

        # 3. SASS of the committed build
        sass = sass_classes(cuobjdump, cuda_lib._lib_path(), KERNELS)
        for kernel, c in sass.items():
            print(f"[3] {kernel}: {json.dumps(c)}", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(device=smi, rows=rows, sass=sass), f, indent=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
