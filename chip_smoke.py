#!/usr/bin/env python3
"""Smoke run of plonkathon_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one line:
  1. the device (torch's name and count, nvidia-smi's name and power limit);
  2. build of the CUDA kernels (one nvcc call) and ptxas's report;
  3. each kernel against its plain torch version ON THE CARD at the n = 2^16
     path's shapes plus edge lanes: equal raw limbs, kernel and plain times
     from CUDA events, and the bound (bytes over 3.35 TB/s vs 32-bit
     multiplies over the card's integer multiply issue rate);
  4. the fixture proof on the ceremony SRS: proof.pickle reproduced field
     for field, the three snarkjs vkeys and the golden commitment, verify;
  5. a mul-chain proof at n = 2^11 on the ceremony SRS, verified;
  6. the headline: a mul-chain proof at n = 2^16 on Setup.generate(2^16),
     verified, with per-round times, wall time and peak device memory.
Phases 4, 5 and 6 each drive the main path with the launch counts set to 0
just before and read just after: each prints its counts and fails unless
every kernel was launched in it.
Then one JSON line of per-kernel records, and as the LAST line
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.
Needs no network; imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")

# Least-time model (see PERF.md): HBM at 3.35 TB/s, and 32-bit integer
# multiplies at 64 per SM per clock (CUDA programming guide, cc 9.0) on
# 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT_MUL_PER_S = 132 * 64 * 1.98e9
# 32-bit multiplies per Montgomery product: 8x8 a*b and 8x8 m*p word
# products (a low and a high half each) plus 8 m digits.
MULS_PER_MONT = 2 * (64 + 64) + 8
MONT_PER_JADD = 16
MONT_PER_MADD = 11
MONT_PER_DOUBLE = 7
HEADLINE_N = 1 << 16
CHAIN_N = 1 << 11

SOURCES = {
    "K1": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:235"),
    "K2": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:287"),
    "K5": ("plonkathon_tpu_torch/csrc/msm.cu", "plonkathon_tpu/ops/msm2.py:126"),
    "K6": ("plonkathon_tpu_torch/csrc/msm.cu", "plonkathon_tpu/ops/msm2.py:55"),
    "K7": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:463"),
}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def chain_lines(n: int) -> list[str]:
    """The mul-chain circuit: out = a^(n-3), one multiply gate per row."""
    lines = ["out public", "c1 <== a * a"]
    lines += [f"c{i} <== c{i-1} * a" for i in range(2, n - 3)]
    lines.append(f"out <== c{n-4} * a")
    return lines


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _bound(nbytes: int, nmont: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nmont * MULS_PER_MONT / INT_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(torch, fn, reps: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(torch, got, want) -> int:
    if isinstance(got, tuple):
        return max(_max_err(torch, g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} vs plain {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _lazy(torch, np, rng, field_ops, w: int, edges: bool = True):
    """Random lazy-domain [0, 2p) elements int32[16, w] on the card; the
    first lanes are 0, p - 1 and 2p - 1."""
    from plonkathon_tpu_torch.ops.limbs import encode_ints

    limbs = rng.integers(0, 1 << 16, size=(16, w), dtype=np.int64)
    limbs[15] = rng.integers(0, int(field_ops.P2[15]), size=w)
    if edges:
        p = field_ops.modulus
        limbs[:, :3] = encode_ints([0, p - 1, 2 * p - 1])
    return torch.from_numpy(limbs.astype(np.int32)).to("cuda")


def _real_point(torch):
    """A real G1 point and its negation as stacked Jacobian [48, 1] (Z = 1)."""
    from plonkathon_tpu_torch.ec import G1, pt_mul, pt_neg
    from plonkathon_tpu_torch.ops.limbs import fq, to_device

    g = pt_mul(G1, 0xC0FFEE)
    out = []
    for pt in (g, pt_neg(g)):
        x, y = (to_device(fq.to_mont_host(int(c)), "cuda")[:, None] for c in pt)
        out.append(torch.cat([x, y, fq.full("ONE_MONT", x)]))
    return out


def _points(torch, np, rng, w: int):
    """Stacked Jacobian pairs (a, b) [48, w]: random coordinates, and in the
    first lanes identity + P, P + identity, P + P and -P + P."""
    from plonkathon_tpu_torch.ops.limbs import fq

    a = torch.cat([_lazy(torch, np, rng, fq, w, edges=False) for _ in range(3)])
    b = torch.cat([_lazy(torch, np, rng, fq, w, edges=False) for _ in range(3)])
    p, neg_p = _real_point(torch)
    ident = torch.cat([p[:32], torch.zeros_like(p[32:])])
    for lane, (pa, pb) in enumerate(((ident, p), (p, ident), (p, p), (neg_p, p))):
        a[:, lane : lane + 1] = pa
        b[:, lane : lane + 1] = pb
    return a, b


def check_kernels(torch, np) -> list[dict]:
    """Each kernel against its plain version on the card, at the headline
    path's shapes."""
    from plonkathon_tpu_torch.ops import cuda_mont as CM, msm2
    from plonkathon_tpu_torch.ops.limbs import fq, fr

    n, reps = HEADLINE_N, 20
    rng = np.random.default_rng(20260817)
    k_msm = 32 * n
    chunks = msm2._choose_chunks(k_msm)
    steps = k_msm // chunks
    cases = []

    # K1: fr at the quotient's 4n width, fq at the window tables' 32n.
    for field, ops, w in (("fr", fr, 4 * n), ("fq", fq, 32 * n)):
        a = _lazy(torch, np, rng, ops, w)
        b = _lazy(torch, np, rng, ops, w)
        b[:, :3] = b[:, 2:3]
        cases.append(dict(
            kernel=f"K1 {field}", name=f"K1 mont_mul ({field})", width=w,
            run=lambda f=field, a=a, b=b: CM.mont_mul(f, a, b),
            plain=lambda f=field, a=a, b=b: CM.mont_mul_plain(f, a, b),
            nbytes=3 * 64 * w, nmont=w,
        ))
    # K2: one Stockham stage of the 4n coset NTT over the 15-polynomial stack.
    w = 15 * 2 * n
    c0, c1, tw = (_lazy(torch, np, rng, fr, w) for _ in range(3))
    cases.append(dict(
        kernel="K2", name="K2 dif_butterfly", width=w,
        run=lambda: CM.dif_butterfly(c0, c1, tw),
        plain=lambda: CM.dif_butterfly_plain(c0, c1, tw),
        nbytes=5 * 64 * w, nmont=w,
    ))
    # K5: first level of the chunk fold, NB * C / 2 points.
    w = msm2.NB * chunks // 2
    pa, pb = _points(torch, np, rng, w)
    cases.append(dict(
        kernel="K5", name="K5 jadd_stacked", width=w,
        run=lambda: msm2.jadd_stacked(pa, pb),
        plain=lambda: msm2.jadd_stacked_plain(pa, pb),
        nbytes=3 * 192 * w, nmont=MONT_PER_JADD * w,
    ))
    # K6: the commit run-scan, S steps x C chunks of sorted digits.
    dig = np.sort(rng.integers(0, msm2.NB, size=(chunks, steps)), axis=1)
    dig[0] = 7  # one long run: the same base twice -> doubling branch
    prev = np.concatenate([dig[:, :1], dig[:, :-1]], axis=1)
    d_t = torch.from_numpy(np.ascontiguousarray(dig.T, dtype=np.int32)).to("cuda")
    p_t = torch.from_numpy(np.ascontiguousarray(prev.T, dtype=np.int32)).to("cuda")
    pts = torch.stack([_lazy(torch, np, rng, fq, chunks, edges=False) for _ in range(2 * steps)])
    pts = pts.reshape(steps, 32, chunks)
    pts[:, :, 0] = _real_point(torch)[0][:32, 0]  # chunk 0: P, P, P, ...
    cases.append(dict(
        kernel="K6", name="K6 run_scan", width=steps * chunks,
        run=lambda: msm2.run_scan(d_t, p_t, pts),
        plain=lambda: msm2.run_scan_plain(d_t, p_t, pts),
        nbytes=(8 + 128 + 192) * steps * chunks, nmont=MONT_PER_MADD * steps * chunks,
    ))
    # K7: one window step of the table build: 8 doublings of n points.
    w = n
    pd = tuple(pa[16 * i : 16 * (i + 1), :w] for i in range(3))
    cases.append(dict(
        kernel="K7", name="K7 jac_double_n", width=w,
        run=lambda: CM.jac_double_n(pd, 8),
        plain=lambda: CM.jac_double_n_plain(pd, 8),
        nbytes=2 * 192 * w, nmont=8 * MONT_PER_DOUBLE * w,
    ))

    records = []
    for c in cases:
        got = c["run"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        err = _max_err(torch, got, want)
        if err != 0:
            fail(f"{c['name']} differs from its plain version (max abs err {err})")
        ms = _timed(torch, c["run"], reps)
        plain_ms = _timed(torch, c["plain"], 1)
        bound_ms, bound_by = _bound(c["nbytes"], c["nmont"])
        src, replaces = SOURCES[c["kernel"].split()[0]]
        records.append(dict(
            name=c["name"], kernel=c["kernel"], route="cuda", source=src,
            replaces=replaces, width=c["width"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=c["nbytes"], int_muls=c["nmont"] * MULS_PER_MONT,
            library_ms=None,
        ))
        print(f"[3] {c['name']}: width {c['width']} equal raw limbs (max abs err "
              f"{err}, tolerance 0: integer arithmetic); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        del got, want
    return records


# ---------------------------------------------------------------------------
# Phases 4-6: the port's main path.
# ---------------------------------------------------------------------------

def fixture_phase(ptt):
    """proof.pickle, the three snarkjs vkeys and the golden commitment."""
    from plonkathon_tpu_torch.fields import Fq

    t0 = time.perf_counter()
    setup = ptt.Setup.from_file(PTAU)
    golden = setup.commit(ptt.Polynomial(list(range(1, 9)), ptt.Basis.LAGRANGE))
    if golden != (
        Fq(16120260411117808045030798560855586501988622612038310041007562782458075125622),
        Fq(3125847109934958347271782137825877642397632921923926105820408033549219695465),
    ):
        fail("golden commitment differs")
    for lines, fixture in (
        (["c <== a * b"], "main.plonk.vkey.json"),
        (["ab === a - c", "-ab === a * b"], "main.plonk.vkey-58.json"),
        (["c public", "c === a * b"], "main.plonk.vkey-59.json"),
    ):
        vk = setup.verification_key(ptt.Program(lines, 8).common_preprocessed_input())
        with open(os.path.join(FIXTURES, fixture)) as f:
            theirs = json.load(f)
        for key in ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3", "X_2"):
            if ptt.interpret_json_point(theirs[key]) != getattr(vk, key):
                fail(f"{fixture}: {key} differs")
        if vk.w != int(theirs["w"]):
            fail(f"{fixture}: w differs")
    program = ptt.Program(["e public", "c <== a * b", "e <== c * d"], 8)
    proof = ptt.Prover(setup, program, debug=True).prove(
        {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}
    )
    ours = proof.flatten()
    theirs = ptt.load_proof_pickle(os.path.join(FIXTURES, "proof.pickle")).flatten()
    if set(ours) != set(theirs) or any(ours[k] != theirs[k] for k in ours):
        fail("proof.pickle not reproduced")
    vk = setup.verification_key(program.common_preprocessed_input())
    if not (vk.verify_proof(8, proof, [60]) and vk.verify_proof_unoptimized(8, proof, [60])):
        fail("fixture proof does not verify")
    print(f"[4] fixture: proof.pickle reproduced field for field ({len(ours)} fields), "
          f"3 snarkjs vkeys and the golden commitment match, both verifiers accept "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


def chain_proof(ptt, setup, n: int):
    """Compile, prove, verify the n-gate mul-chain; returns (prover, witness,
    prove wall s)."""
    program = ptt.Program(chain_lines(n), n)
    witness = program.fill_variable_assignments({"a": 3})
    prover = ptt.Prover(setup, program)
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    wall = time.perf_counter() - t0
    vk = setup.verification_key(program.common_preprocessed_input())
    if not vk.verify_proof(n, proof, [witness["out"]]):
        fail(f"the n = {n} mul-chain proof does not verify")
    flat = proof.flatten()
    if any(flat[k] is None for k in flat):
        fail(f"the n = {n} proof has an identity commitment")
    return prover, witness, wall


def device_breakdown(torch, fn, top: int = 8) -> dict:
    """Run fn() under torch.profiler; device time by kernel (ms), the sum
    over all kernels, the wall time and the device busy share."""
    import re
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"k\d_kernel", evt.name)
        name = m.group(0) if m else "torch:" + evt.name.split("<")[0].split("(")[0][-40:]
        by_name[name] = by_name.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    total = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    torch_ms = sum(v for k, v in by_name.items() if k.startswith("torch:"))
    return {
        "wall_ms": wall * 1e3, "device_ms": total, "busy_share": total / (wall * 1e3),
        "torch_ops_ms": torch_ms,
        "top": [[k, round(v, 3)] for k, v in ranked[:top]],
    }


def launches_since_reset(torch, cuda_lib, phase: str) -> dict:
    """The launch counts since the last reset; fails unless every kernel of
    the path was launched."""
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"{phase}: kernels never launched on the main path: {missing}")
    return launches


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "plonkathon_tpu_torch")):
        fail("plonkathon_tpu_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import plonkathon_tpu_torch as ptt
    from plonkathon_tpu_torch.ops import cuda_lib

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {kind} x{count}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"[2] built {', '.join(cuda_lib.SOURCES)} in one nvcc call in "
          f"{time.perf_counter() - t0:.1f} s; nvcc's report follows", flush=True)
    print(cuda_lib.build_log().rstrip(), flush=True)

    # 3. kernels against plain versions
    records = check_kernels(torch, np)

    # 4. fixture proof, vkeys, golden commitment
    cuda_lib.reset_launches()
    fixture_phase(ptt)
    launches = launches_since_reset(torch, cuda_lib, "fixture")
    print(f"[4] fixture launches {json.dumps(launches)}", flush=True)

    # 5. mul-chain at n = 2^11 on the ceremony SRS
    cuda_lib.reset_launches()
    setup11 = ptt.Setup.from_file(PTAU)
    _, _, wall11 = chain_proof(ptt, setup11, CHAIN_N)
    launches = launches_since_reset(torch, cuda_lib, f"n = {CHAIN_N}")
    print(f"[5] mul-chain n = {CHAIN_N} on the ceremony SRS: verified; "
          f"cold prove {wall11:.3f} s, launches {json.dumps(launches)}", flush=True)
    del setup11

    # 6. headline: mul-chain at n = 2^16 on a synthetic SRS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    setup = ptt.Setup.generate(HEADLINE_N)
    t_setup = time.perf_counter() - t0
    prover, witness, cold = chain_proof(ptt, setup, HEADLINE_N)
    launches = launches_since_reset(torch, cuda_lib, f"n = {HEADLINE_N}")
    peak = torch.cuda.max_memory_allocated()
    prover.timings = type(prover.timings)(prover.device)
    t0 = time.perf_counter()
    prover.prove(dict(witness))
    warm = time.perf_counter() - t0
    rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    breakdown = device_breakdown(torch, lambda: prover.prove(dict(witness)))
    print(f"[6] mul-chain n = {HEADLINE_N} on Setup.generate: verified; "
          f"setup {t_setup:.2f} s, cold prove {cold:.3f} s (window tables "
          f"included), warm prove {warm:.3f} s, warm rounds ms {json.dumps(rounds)}, "
          f"launches {json.dumps(launches)}, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[6] profiled warm prove: {json.dumps(breakdown)}", flush=True)

    for r in records:
        r["launches"] = launches[r["kernel"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
