#!/usr/bin/env python3
"""Launch configurations, products, compile times and SASS of K6 and K8a.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/sweep_k6_k8a.py [--compile-only] [--parent-csrc DIR] [--json PATH]

It prints:
  1. each CUDA source of plonkathon_tpu_torch/csrc compiled alone (the
     flags of ops/cuda_lib.py), and msm.cu once more from a copy whose
     jac_madd_core_pair (K6's pair schedule) runs on the 64-bit CIOS
     product fe_mul instead of the carry chains, with the wall time and
     ptxas's stack frame, spills and registers for k6_kernel, k8a_kernel
     and k8a_window_kernel (--compile-only stops here);
  2. K6 (the msm2 fallback's scan, S 512 x C 2^14) at each threads-per-block
     count on both products, and K8a's window sum (Setup.generate at
     n = 2^18: 32 windows of 2^18 points) at each threads x minimum-blocks
     pair, every build compiled in parallel from a copy of the sources with
     the constants replaced, timed with CUDA events (mean of 20 launches,
     5 for the window routes, after a warm-up) in two rounds, the second in
     reverse order, and held against the committed build's output (max abs
     err); beside them the window sum as the port ran it before one launch
     did it: five elementwise K8a launches, one per level, each over both
     operands copied out of their stride-2 slices ([16, n, 32] gather),
     on the committed k8a_kernel and, with `--parent-csrc`, on another
     csrc directory's (say an earlier commit's, unpacked with `git
     archive`), whose k6_kernel joins the K6 rows; the old route and the
     one launch are also profiled (device ms by kernel: the add launches
     against the copies);
  3. the SASS of the committed build and of the 64-bit K6 build (cuobjdump
     -sass): instructions by opcode class, local loads and stores among
     them.
It fails without a card or when a build's output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from sweep_k3_k7 import compile_copy, ptxas_report, sass_classes  # noqa: E402

CSRC = os.path.join(ROOT, "plonkathon_tpu_torch", "csrc")
KERNELS = ("k6_kernel", "k8a_kernel", "k8a_window_kernel")
# (tag, source, kernel, {constant: value}, 64-bit K6 product) for each
# configuration.
CONFIGS = (
    [(f"k6 {t} {'wide' if w else 'ptx'}", "msm.cu", "k6_kernel", {"kScanThreads": t}, w)
     for w in (False, True) for t in (64, 128, 256)]
    + [(f"k8a win {t}x{m}", "mont.cu", "k8a_window_kernel",
        {"kWinThreads": t, "kWinMinBlocks": m}, False)
       for t, m in ((64, 8), (32, 16), (64, 6), (64, 4), (128, 4), (128, 2))]
)


def wide_csrc(work: str) -> str:
    """A copy of csrc whose jac_madd_core_pair runs its five products and
    its squaring on the 64-bit CIOS product (fe_mul) instead of the carry
    chains: the same integers, another instruction mix."""
    d = os.path.join(work, "csrc_wide")
    shutil.copytree(CSRC, d)
    path = os.path.join(d, "g1.cuh")
    text = open(path).read()
    start = text.index("__device__ __forceinline__ Jac jac_madd_core_pair(")
    end = text.index("\n}\n", start)
    body, n_sqr = re.subn(r"fe_sqr_ptx\(p\.z, c\)", "fe_mul(p.z, p.z, c)", text[start:end])
    body, n_mul = re.subn(r"fe_mul_ptx\(", "fe_mul(", body)
    if (n_sqr, n_mul) != (1, 5):
        raise RuntimeError(f"jac_madd_core_pair: {n_sqr} squarings, {n_mul} products")
    with open(path, "w") as f:
        f.write(text[:start] + body + text[end:])
    return d


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compile-only", action="store_true", help="stop after part 1")
    ap.add_argument("--parent-csrc", help="another csrc directory to time beside")
    ap.add_argument("--json", help="write the rows to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_k6_k8a: needs a CUDA card")
    import chip_smoke as cs
    from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm2

    nvcc = cuda_lib._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = list(cuda_lib.NVCC_FLAGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix="sweep_k6_k8a_")
    try:
        # 1. each source alone, and msm.cu with the 64-bit K6
        wide = wide_csrc(work)
        alone_jobs = [("alone_msm.cu", CSRC, "msm.cu"), ("alone_mont.cu", CSRC, "mont.cu"),
                      ("alone_msm3.cu", CSRC, "msm3.cu"), ("alone_msm.cu_wide", wide, "msm.cu")]
        with ThreadPoolExecutor(4) as ex:
            alone = list(ex.map(lambda j: compile_copy(work, nvcc, flags, j[0], j[1], j[2]),
                                alone_jobs))
        compiles = []
        for b in alone:
            print(f"[1] {b['tag'][6:]} alone: rc {b['rc']}, {b['build_s']:.1f} s", flush=True)
            row = dict(source=b["tag"][6:], rc=b["rc"], build_s=b["build_s"])
            for kernel in KERNELS:
                if f"{len(kernel)}{kernel}" in b["log"]:
                    row[kernel] = ptxas_report(b["log"], kernel)
                    print(f"    {kernel}: {row[kernel]}", flush=True)
            compiles.append(row)
            if b["rc"]:
                raise SystemExit(b["log"][-4000:])
        if args.compile_only:
            return

        # 2. configurations, against the committed build
        cuda_lib.build()
        rng = np.random.default_rng(7)
        n = cs.HEADLINE_N
        k_msm = 32 * n
        chunks = msm2._choose_chunks(k_msm)
        steps = k_msm // chunks
        d_t, p_t, pts = cs._scan_case(torch, np, rng, steps, chunks)
        win = cs._window_points(torch, np, rng, n)
        win_n = tuple(c.transpose(1, 2).contiguous() for c in win)  # the old [16, n, 32] gather
        consts = CM.field_consts("fq")
        stream = torch.cuda.current_stream().cuda_stream
        P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        out6 = torch.empty((steps, 48, chunks), dtype=torch.int32, device="cuda")
        outw = torch.empty((48, n), dtype=torch.int32, device="cuda")
        refs = {
            "k6_kernel": msm2.run_scan(d_t, p_t, pts),
            "k8a_window_kernel": torch.cat(CM.jac_window_sum(win)),
        }
        refs["k8a_kernel"] = refs["k8a_window_kernel"]

        def five_launches(add):
            """The window sum as five elementwise launches of `add`, the
            level-by-level halving over the [16, n, 32] gather that one
            launch replaced: each level stacks both stride-2 operands (a
            copy each) and launches."""
            def run():
                x, y, z = win_n
                m = 32
                while m > 1:
                    w = n * m // 2
                    a = torch.cat([c[..., 0::2].reshape(16, w) for c in (x, y, z)])
                    b = torch.cat([c[..., 1::2].reshape(16, w) for c in (x, y, z)])
                    o = torch.empty_like(a)
                    rc = add(a.data_ptr(), b.data_ptr(), o.data_ptr(), w, consts, stream)
                    if rc != 0:
                        raise SystemExit(f"k8a_jac_add failed, cudaError {rc}")
                    m //= 2
                    x, y, z = (o[16 * i : 16 * (i + 1)].reshape(16, n, m) for i in range(3))
                return torch.cat([x[..., 0], y[..., 0], z[..., 0]])
            return run

        def launcher(so, kernel):
            """(launch returning (rc, output), reps) of `kernel` in `so`."""
            if kernel == "k6_kernel":
                f = so.k6_run_scan
                f.argtypes = [P, P, P, P, I64, I64, P, P]
                return (lambda: (f(d_t.data_ptr(), p_t.data_ptr(), pts.data_ptr(),
                                   out6.data_ptr(), steps, chunks, consts, stream), out6)), 20
            if kernel == "k8a_window_kernel":
                f = so.k8a_window_sum
                f.argtypes = [P, P, P, P, I64, I32, P, P]
                return (lambda: (f(win[0].data_ptr(), win[1].data_ptr(), win[2].data_ptr(),
                                   outw.data_ptr(), n, 32, consts, stream), outw)), 5
            f = so.k8a_jac_add
            f.argtypes = [P, P, P, I64, P, P]
            run = five_launches(f)
            return (lambda: (0, run())), 5

        jobs = [(tag, wide if w else CSRC, src, kernel, c) for tag, src, kernel, c, w in CONFIGS]
        jobs.append(("k8a five launches", CSRC, "mont.cu", "k8a_kernel", None))
        if args.parent_csrc:
            jobs += [("k6 parent", args.parent_csrc, "msm.cu", "k6_kernel", None),
                     ("k8a five launches parent", args.parent_csrc, "mont.cu", "k8a_kernel",
                      None)]
        with ThreadPoolExecutor(8) as ex:
            builds = list(ex.map(
                lambda j: compile_copy(work, nvcc, flags, j[0].replace(" ", "_"), j[1], j[2], j[4]),
                jobs))
        rows, runs = [], {}
        order = list(zip(jobs, builds))
        for rnd in range(2):
            for job, b in (order if rnd == 0 else order[::-1]):
                tag, kernel = job[0], job[3]
                if b["rc"]:
                    if rnd == 0:
                        print(f"[2] {tag}: build failed\n{b['log'][-1500:]}", flush=True)
                        rows.append(dict(config=tag, build_failed=True, log=b["log"][-1500:]))
                    continue
                fn, reps = launcher(ctypes.CDLL(b["so"]), kernel)
                rc, out = fn()
                torch.cuda.synchronize()
                if rc != 0:
                    raise SystemExit(f"{tag}: launch failed, cudaError {rc}")
                err = int((out.long() - refs[kernel].long()).abs().max())
                ms = cs._timed(torch, fn, reps)
                runs[tag] = fn
                rows.append(dict(config=tag, round=rnd, ms=ms, max_abs_err=err,
                                 build_s=b["build_s"], ptxas=ptxas_report(b["log"], kernel)))
                print(f"[2] {tag:<26} round {rnd}: {ms:.4f} ms, max abs err {err}"
                      + (f", build {b['build_s']:.1f} s; {rows[-1]['ptxas']}" if rnd == 0 else ""),
                      flush=True)
                if err != 0:
                    raise SystemExit(f"{tag} differs from the committed build")
        # Device time by kernel: the five-launch routes against the one launch.
        profiles = {}
        for tag in ("k8a win 64x8", "k8a five launches", "k8a five launches parent"):
            if tag in runs:
                profiles[tag] = cs.device_breakdown(torch, runs[tag])
                print(f"[2] {tag} profiled: {json.dumps(profiles[tag])}", flush=True)

        # 3. SASS of the committed build, and of the 64-bit K6
        sass = sass_classes(cuobjdump, cuda_lib._lib_path(), KERNELS)
        wide_so = next(b["so"] for b in alone if b["tag"] == "alone_msm.cu_wide")
        sass["k6_kernel wide"] = sass_classes(cuobjdump, wide_so, ("k6_kernel",))["k6_kernel"]
        for kernel, c in sass.items():
            print(f"[3] {kernel}: {json.dumps(c)}", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(device=smi, compiles=compiles, rows=rows, profiles=profiles,
                               sass=sass), f, indent=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
