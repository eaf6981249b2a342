#!/usr/bin/env python3
"""Launch configurations, compile times and SASS of the elementwise K8a add
and K8b.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/sweep_k8.py [--compile-only] [--parent-csrc DIR] [--json PATH]

It prints:
  1. each CUDA source of plonkathon_tpu_torch/csrc compiled alone (the
     flags of ops/cuda_lib.py), with the wall time and ptxas's stack frame,
     spills and registers for k8a_kernel, k8b_kernel and k7_kernel
     (--compile-only stops here);
  2. both kernels at w = 2^20 on chip_smoke.py's inputs (random lazy
     coordinates, edge lanes identity + P, P + identity, P + P, -P + P),
     launched on the coordinate views the wrapper hands over: mont.cu's
     kernels (K8a add on a thread pair per add, K8b on one thread) at each
     threads-per-block x minimum-blocks pair of CONFIGS, each build compiled
     in parallel from a copy of the sources with the constants replaced;
     the designs they beat (scripts/sweep_k8_variants.cu: K8a add on one
     thread per add, K8b on a thread pair, and both staging each thread's
     next point in shared memory by cp.async); and, with --parent-csrc (say
     an earlier commit's csrc, unpacked with `git archive`), the stacked-
     operand kernels of that source, timed alone and with the two copies
     its wrapper made before each launch.  Each is timed with CUDA events
     (mean of 20 launches after a warm-up) in two rounds, the second in
     reverse order, and held against the committed build's wrapper (max abs
     err).  Then the committed wrappers' call time against their device
     time (torch.profiler), and K7's wrapper on coordinate rows of one
     [48, n] (no copy) against separate coordinates (the copy it made
     before);
  3. the SASS of the committed build (cuobjdump -sass): instructions by
     opcode class, local loads and stores among them.
It fails without a card or when a build's output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from sweep_k3_k7 import compile_copy, ptxas_report, sass_classes  # noqa: E402

CSRC = os.path.join(ROOT, "plonkathon_tpu_torch", "csrc")
VARIANTS_SRC = os.path.join(ROOT, "scripts", "sweep_k8_variants.cu")
KERNELS = ("k8a_kernel", "k8b_kernel", "k7_kernel")
W = 1 << 20
# (tag, (threads, minimum blocks) of K8a add, the same of K8b); the first
# is the committed one.
CONFIGS = (
    ("a t256 b2, b t256 b2", (256, 2), (256, 2)),
    ("a t192 b2, b t192 b2", (192, 2), (192, 2)),
    ("a t384 b1, b t384 b1", (384, 1), (384, 1)),
    ("a t512 b1, b t512 b1", (512, 1), (512, 1)),
    ("a t128 b4, b t128 b1", (128, 4), (128, 1)),
    ("a t64 b8, b t64 b8", (64, 8), (64, 8)),
)
# Threads and minimum blocks of the variants' one-thread K8a add and
# thread-pair K8b, one build each.
VARIANT_CONFIGS = ((64, 8), (256, 2))
# (label, kernel, C entry point, function) of each build's launches.
COMMITTED = (("", "k8a", "k8a_jac_add", "k8a_kernel"), ("", "k8b", "k8b_jac_madd", "k8b_kernel"))
VARIANTS = (("one thread", "k8a", "k8a_one", "k8a_one_kernel"),
            ("thread pair", "k8b", "k8b_pair", "k8b_pair_kernel"),
            ("cp.async staged", "k8a", "k8a_staged", "k8a_staged_kernel"),
            ("cp.async staged", "k8b", "k8b_staged", "k8b_staged_kernel"))
PARENT = tuple((label, which, entry, f"{which}_kernel")
               for label in ("parent kernel", "parent call")
               for which, entry in (("k8a", "k8a_jac_add"), ("k8b", "k8b_jac_madd")))


def config_consts(a, b) -> dict:
    return {"kK8aThreads": a[0], "kK8aMinBlocks": a[1],
            "kK8bThreads": b[0], "kK8bMinBlocks": b[1]}


def compile_variants(work, nvcc, flags, threads, min_blocks):
    """sweep_k8_variants.cu against a copy of the committed headers, its
    one-thread and thread-pair kernels at `threads` x `min_blocks`."""
    d = os.path.join(work, f"variants_{threads}_{min_blocks}")
    shutil.copytree(CSRC, d)
    shutil.copy(VARIANTS_SRC, d)
    return compile_copy(work, nvcc, flags, f"variants_{threads}_{min_blocks}_build", d,
                        "sweep_k8_variants.cu",
                        {"kOneThreads": threads, "kOneMinBlocks": min_blocks,
                         "kPairThreads": threads, "kPairMinBlocks": min_blocks})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compile-only", action="store_true", help="stop after part 1")
    ap.add_argument("--parent-csrc", help="another csrc directory to time beside")
    ap.add_argument("--json", help="write the rows to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_k8: needs a CUDA card")
    import chip_smoke as cs
    from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM

    nvcc = cuda_lib._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = list(cuda_lib.NVCC_FLAGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix="sweep_k8_")
    try:
        # 1. each source alone
        with ThreadPoolExecutor(3) as ex:
            alone = list(ex.map(lambda s: compile_copy(work, nvcc, flags, f"alone_{s}", CSRC, s),
                                cuda_lib.SOURCES))
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
        rng = np.random.default_rng(20261017)
        a, b = cs._points(torch, np, rng, W)
        ca, cb = CM.unstack_points(a, (W,)), CM.unstack_points(b, (W,))
        refs = {"k8a": torch.cat(CM.jac_add(ca, cb)), "k8b": torch.cat(CM.jac_madd(ca, cb[:2]))}
        consts = CM.field_consts("fq")
        stream = torch.cuda.current_stream().cuda_stream
        P, I64 = ctypes.c_void_p, ctypes.c_longlong
        out = torch.empty((48, W), dtype=torch.int32, device="cuda")
        rows_of = {"k8a": 96, "k8b": 80}
        strides = {k: (I64 * (r // 8))(*([W, 1] * (r // 16))) for k, r in rows_of.items()}
        operands = {"k8a": [a[16 * i : 16 * i + 16].data_ptr() for i in range(3)]
                    + [b[16 * i : 16 * i + 16].data_ptr() for i in range(3)],
                    "k8b": [a[16 * i : 16 * i + 16].data_ptr() for i in range(3)]
                    + [b[16 * i : 16 * i + 16].data_ptr() for i in range(2)]}

        def launcher(so, label, which, entry):
            """A launch returning (rc, output) of `entry` in the library `so`."""
            f = getattr(so, entry)
            q = b if which == "k8a" else b[:32]
            if label == "parent kernel":
                f.argtypes = [P, P, P, I64, P, P]
                return lambda: (f(a.data_ptr(), q.data_ptr(), out.data_ptr(), W, consts,
                                  stream), out)
            if label == "parent call":
                f.argtypes = [P, P, P, I64, P, P]
                nq = 3 if which == "k8a" else 2

                def with_copies():  # the parent wrapper: stack p and q, then launch
                    sa = torch.cat([c.reshape(16, W) for c in ca])
                    sb = torch.cat([c.reshape(16, W) for c in cb[:nq]])
                    return f(sa.data_ptr(), sb.data_ptr(), out.data_ptr(), W, consts,
                             stream), out
                return with_copies
            n_ops = rows_of[which] // 16
            f.argtypes = [P] * (n_ops + 2) + [I64, P, P]
            ptrs = operands[which]
            return lambda: (f(*ptrs, strides[which], out.data_ptr(), W, consts, stream), out)

        jobs = [(tag, COMMITTED, lambda c=config_consts(ka, kb), t=tag: compile_copy(
            work, nvcc, flags, t.replace(" ", "_").replace(",", ""), CSRC, "mont.cu", c))
            for tag, ka, kb in CONFIGS]
        for t, m in VARIANT_CONFIGS:
            jobs.append((f"t{t} b{m}", VARIANTS if (t, m) == VARIANT_CONFIGS[0] else VARIANTS[:2],
                         lambda t=t, m=m: compile_variants(work, nvcc, flags, t, m)))
        if args.parent_csrc:
            jobs.append(("", PARENT, lambda: compile_copy(work, nvcc, flags, "parent",
                                                          args.parent_csrc, "mont.cu")))
        with ThreadPoolExecutor(8) as ex:
            builds = list(ex.map(lambda j: j[2](), jobs))
        order = [(label, " ".join(x for x in (label, tag) if x), which, entry, fn_name, bld)
                 for (tag, launches, _), bld in zip(jobs, builds)
                 for label, which, entry, fn_name in launches]
        rows = []
        for rnd in range(2):
            for label, tag, which, entry, fn_name, bld in (order if rnd == 0 else order[::-1]):
                if bld["rc"]:
                    if rnd == 0:
                        print(f"[2] {which} {tag}: build failed\n{bld['log'][-1500:]}",
                              flush=True)
                        rows.append(dict(config=tag, kernel=which, build_failed=True,
                                         log=bld["log"][-1500:]))
                    continue
                run = launcher(ctypes.CDLL(bld["so"]), label, which, entry)
                out.zero_()
                rc, got = run()
                torch.cuda.synchronize()
                if rc != 0:
                    raise SystemExit(f"{tag} {which}: launch failed, cudaError {rc}")
                err = int((got.long() - refs[which].long()).abs().max())
                ms = cs._timed(torch, run, 20)
                ptx = ptxas_report(bld["log"], fn_name)
                rows.append(dict(config=tag, kernel=which, round=rnd, ms=ms, max_abs_err=err,
                                 build_s=bld["build_s"], ptxas=ptx))
                print(f"[2] {which} {tag:<24} round {rnd}: {ms:.4f} ms, max abs err {err}"
                      + (f", build {bld['build_s']:.1f} s; {ptx}" if rnd == 0 else ""),
                      flush=True)
                if err != 0:
                    raise SystemExit(f"{tag} {which} differs from the committed build")

        # The committed wrappers: call time (CUDA events) against device time.
        calls = {"k8a": lambda: CM.jac_add(ca, cb), "k8b": lambda: CM.jac_madd(ca, cb[:2])}
        wrappers = {}
        for which, call in calls.items():
            ms = cs._timed(torch, call, 20)
            prof = cs.device_breakdown(torch, call)
            wrappers[which] = dict(call_ms=ms, device_ms=prof["device_ms"], top=prof["top"])
            print(f"[2] {which} wrapper: call {ms:.4f} ms, device {prof['device_ms']:.4f} ms "
                  f"{json.dumps(prof['top'])}", flush=True)

        # K7 on coordinate rows of one [48, n] (no copy) and on separate
        # coordinates (a copy into a stacked [48, n] first), at n = 2^18.
        n = cs.HEADLINE_N
        p7 = CM.unstack_points(cs._points(torch, np, rng, n)[0], (n,))
        apart = tuple(c.clone() for c in p7)
        k7 = {}
        for nd in (16, 8):
            if not all(torch.equal(x, y) for x, y in
                       zip(CM.jac_double_n(p7, nd), CM.jac_double_n(apart, nd))):
                raise SystemExit("K7 differs between the two operand layouts")
            for rnd in range(2):
                for tag, pts in ((("rows", p7), ("apart", apart)) if rnd == 0
                                 else (("apart", apart), ("rows", p7))):
                    ms = cs._timed(torch, lambda: CM.jac_double_n(pts, nd), 20)
                    k7.setdefault(f"{nd} doublings, {tag}", []).append(ms)
        for key, ms in k7.items():
            print(f"[2] K7 {key}: {', '.join(f'{m:.4f}' for m in ms)} ms", flush=True)

        # 3. SASS of the committed build
        sass = sass_classes(cuobjdump, cuda_lib._lib_path(), KERNELS)
        for kernel, c in sass.items():
            print(f"[3] {kernel}: {json.dumps(c)}", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(device=smi, compiles=compiles, rows=rows, wrappers=wrappers,
                               k7=k7, sass=sass), f, indent=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
