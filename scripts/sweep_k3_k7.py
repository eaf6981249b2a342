#!/usr/bin/env python3
"""Launch configurations, compile times and SASS of the port's K3 and K7.

Run from the repository root on a machine with one NVIDIA card:

    python3 scripts/sweep_k3_k7.py [--parent-csrc DIR] [--json PATH]

It prints:
  1. each CUDA source of plonkathon_tpu_torch/csrc compiled alone (the
     flags of ops/cuda_lib.py), with its wall time and ptxas's stack frame,
     spills and registers for k3_kernel and k7_kernel;
  2. K3 (the headline run-scan, S 32 x C 2^17) and K7 (2^18 points, 16 and
     8 doublings) built at each threads-per-block / minimum-blocks-per-SM
     pair below, every build compiled in parallel from a copy of the sources
     with the two constants replaced, timed with CUDA events (mean of 20
     launches after a warm-up) in two rounds, the second in reverse order,
     and held against the committed build's output (max abs err);
     `--parent-csrc` adds the kernels of another csrc directory (say an
     earlier commit's, unpacked with `git archive`) to the same rounds;
  3. the SASS of the committed build (cuobjdump -sass): instructions of
     k3_kernel and k7_kernel by opcode class, local loads and stores among
     them.
It fails without a card or when a build's output differs.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "plonkathon_tpu_torch", "csrc")
K3_CONFIGS = [(256, 1), (128, 1), (128, 2), (128, 3), (256, 2), (512, 1), (64, 4)]
K7_CONFIGS = [(512, 1), (256, 1), (128, 2), (256, 2), (256, 3), (128, 3), (128, 4)]
SOURCE_OF = {"k3": "msm3.cu", "k7": "mont.cu"}


def ptxas_report(log: str, kernel: str) -> str:
    """ptxas's stack/spill line and register line for `kernel`."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return " | ".join(x.strip() for x in lines[i + 2 : i + 4])
    return "(no ptxas report)"


def compile_copy(work, nvcc, flags, tag, csrc, source, consts=None):
    """Copy `csrc`, set the kernel's launch constants, compile `source`."""
    d = os.path.join(work, tag)
    shutil.copytree(csrc, d)
    path = os.path.join(d, source)
    if consts:
        text = open(path).read()
        for name, value in consts.items():
            text, n = re.subn(rf"{name} = \d+", f"{name} = {value}", text)
            if n != 1:
                raise RuntimeError(f"{tag}: {name} not found once in {source}")
        with open(path, "w") as f:
            f.write(text)
    so = os.path.join(d, "lib.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-o", so, path], capture_output=True, text=True)
    return dict(tag=tag, rc=proc.returncode, build_s=time.perf_counter() - t0,
                log=proc.stdout + proc.stderr, so=so)


def sass_classes(cuobjdump: str, so: str, kernels=("k3_kernel", "k7_kernel")) -> dict:
    """Opcode counts of each kernel of `kernels` in `so`."""
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = next((k for k in kernels if f"{len(k)}{k}" in m.group(1)), None)
            if cur:
                counts[cur] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur:
            counts[cur][m.group(1)] += 1
    out = {}
    for kernel, c in counts.items():
        def cls(pred):
            return sum(v for op, v in c.items() if pred(op))
        out[kernel] = dict(
            total=sum(c.values()),
            imad=cls(lambda op: op.startswith("IMAD") and not op.startswith("IMAD.MOV")),
            iadd3_x=c["IADD3.X"], iadd3=c["IADD3"],
            local_loads=cls(lambda op: op.startswith("LDL")),
            local_stores=cls(lambda op: op.startswith("STL")),
            global_loads=cls(lambda op: op.startswith("LDG")),
            global_stores=cls(lambda op: op.startswith("STG")),
        )
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", help="another csrc directory to time beside")
    ap.add_argument("--json", help="write the rows to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep_k3_k7: needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm3

    nvcc = cuda_lib._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = list(cuda_lib.NVCC_FLAGS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix="sweep_k3_k7_")
    try:
        # 1. each source alone
        with ThreadPoolExecutor(3) as ex:
            alone = list(ex.map(lambda s: compile_copy(work, nvcc, flags, f"alone_{s}", CSRC, s),
                                ("msm3.cu", "mont.cu", "msm.cu")))
        for b in alone:
            print(f"[1] {b['tag'][6:]} alone: rc {b['rc']}, {b['build_s']:.1f} s", flush=True)
            for kernel in ("k3_kernel", "k7_kernel"):
                if kernel in b["log"]:
                    print(f"    {kernel}: {ptxas_report(b['log'], kernel)}", flush=True)
            if b["rc"]:
                raise SystemExit(b["log"][-4000:])

        # 2. configurations, against the committed build
        cuda_lib.build()
        rng = np.random.default_rng(5)
        n = cs.HEADLINE_N
        steps, lanes, _, _, _ = msm3.plan_params(16 * n)
        acc3, pts3, mask3 = cs._inc_case(torch, np, rng, "madd", steps, lanes, [0, 1, 2, 3])
        ref3 = msm3._inc_scan("madd", acc3, pts3, mask3)
        p7, _ = cs._points(torch, np, rng, n)
        p7 = p7.contiguous()
        ref7 = {nd: torch.cat(CM.jac_double_n(tuple(p7[16 * i : 16 * (i + 1)] for i in range(3)), nd))
                for nd in (16, 8)}
        jobs = [(f"k3 {t}x{m}", CSRC, "msm3.cu", {"kK3Threads": t, "kK3MinBlocks": m})
                for t, m in K3_CONFIGS]
        jobs += [(f"k7 {t}x{m}", CSRC, "mont.cu", {"kK7Threads": t, "kK7MinBlocks": m})
                 for t, m in K7_CONFIGS]
        if args.parent_csrc:
            jobs += [(f"{k} parent", args.parent_csrc, src, None) for k, src in SOURCE_OF.items()]
        with ThreadPoolExecutor(8) as ex:
            builds = list(ex.map(lambda j: compile_copy(work, nvcc, flags, j[0].replace(" ", "_"), *j[1:]), jobs))
        consts = CM.field_consts("fq")
        stream = torch.cuda.current_stream().cuda_stream
        P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        out3, out7 = torch.empty_like(ref3), torch.empty_like(p7)

        def runs(job, b):
            so = ctypes.CDLL(b["so"])
            if job[0].startswith("k3"):
                f = so.k3_madd_packed
                f.argtypes = [P, P, P, P, I64, I64, P, P]
                yield "", out3, ref3, lambda: f(acc3.data_ptr(), pts3.data_ptr(), mask3.data_ptr(),
                                                out3.data_ptr(), steps, lanes, consts, stream)
            else:
                f = so.k7_jac_double_n
                f.argtypes = [P, P, I64, I32, P, P]
                for nd in (16, 8):
                    yield f" x{nd}", out7, ref7[nd], (lambda nd=nd: f(p7.data_ptr(), out7.data_ptr(),
                                                                      n, nd, consts, stream))

        rows = []
        order = list(zip(jobs, builds))
        for rnd in range(2):
            for job, b in (order if rnd == 0 else order[::-1]):
                if b["rc"]:
                    raise SystemExit(f"{job[0]}: build failed\n{b['log'][-4000:]}")
                kernel = "k3_kernel" if job[0].startswith("k3") else "k7_kernel"
                for suffix, out, ref, fn in runs(job, b):
                    rc = fn()
                    torch.cuda.synchronize()
                    if rc != 0:
                        raise SystemExit(f"{job[0]}{suffix}: launch failed, cudaError {rc}")
                    err = int((out.long() - ref.long()).abs().max())
                    ms = cs._timed(torch, fn, 20)
                    rows.append(dict(config=job[0] + suffix, round=rnd, ms=ms, max_abs_err=err,
                                     build_s=b["build_s"], ptxas=ptxas_report(b["log"], kernel)))
                    print(f"[2] {job[0] + suffix:<16} round {rnd}: {ms:.4f} ms, max abs err {err}"
                          + (f", build {b['build_s']:.1f} s; {rows[-1]['ptxas']}" if rnd == 0 else ""),
                          flush=True)
                    if err != 0:
                        raise SystemExit(f"{job[0]}{suffix} differs from the committed build")

        # 3. SASS of the committed build
        sass = sass_classes(cuobjdump, cuda_lib._lib_path())
        for kernel, c in sass.items():
            print(f"[3] {kernel}: {json.dumps(c)}", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(device=smi, rows=rows, sass=sass), f, indent=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
