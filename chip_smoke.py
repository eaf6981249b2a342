#!/usr/bin/env python3
"""Smoke run of plonkathon_tpu_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its lines:
  1. the device (torch's name and count, nvidia-smi's name and power limit);
  2. build of the CUDA kernels (one nvcc call) and ptxas's report;
  3. each of the ten kernels against its plain torch version ON THE CARD at
     the n = 2^18 path's shapes (Setup.generate's window sum, its msm3
     commits, four-step NTTs and its one msm2 fallback commit) plus edge
     lanes -- among them one whole msm3 suffix fold (one K5 launch) against
     the same fold on CPU copies, all J dense-bucket rounds (one K4 launch)
     and the 32-window sum of 2^18 points (one K8a launch), and the
     elementwise K8a add and K8b once more, equality only, at a ragged width
     on a column slice and a [16, 1] broadcast: equal raw
     limbs, kernel and plain times from CUDA events, the bound (bytes over
     3.35 TB/s vs 32-bit multiplies, products and squarings counted apart,
     over the card's integer multiply rate) and ptxas's registers, stack
     frame and spills for the kernel's function;
  4. the fixture proof on the ceremony SRS: proof.pickle reproduced field
     for field, the three snarkjs vkeys and the golden commitment, verify;
  5. a mul-chain proof at n = 2^11 on the ceremony SRS, verified (commits
     through msm2, NTTs through the Stockham transform);
  6. a mul-chain proof at n = 2^16 on Setup.generate(2^16), verified
     (commits through msm3, NTTs through the four-step transform);
  7. the headline: a mul-chain proof at n = 2^18 on Setup.generate(2^18),
     verified, with per-round times, wall time, peak device memory and a
     profiled warm proof;
  8. msm3 commits at m = 2^18 against the exact oracle p(tau) * G (the
     synthetic SRS's tau is known): random coefficients, a crafted
     multiplicity overflow that must fall back to msm2, and both through
     commit_batch.
Each phase drives its path with the launch counts set to 0 just before and
read just after, prints its counts, and fails unless every kernel of ITS
path (REQUIRED below) was launched in it.
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
# products (a low and a high half each) plus 8 m digits; a squaring needs
# 72 for a*a (each cross product once, 28 x 2, plus 8 x 2 squares), 8 and
# 128.  Every point kernel's bound counts its products and squarings
# apart, (products, squarings) per operation:
MULS_PER_MUL = 2 * (64 + 64) + 8
MULS_PER_SQR = 72 + 8 + 128
OPS_FIELD = (1, 0)
OPS_MADD = (8, 3)     # K3, K6, K8b
OPS_JADD = (12, 4)    # K4, K5, K8a
OPS_DOUBLE = (2, 5)   # K7, per doubling
HEADLINE_N = 1 << 18
MID_N = 1 << 16
CHAIN_N = 1 << 11
TAU = 0xDEADBEEF1337  # Setup.generate's known tau: the MSM oracle needs it

SOURCES = {
    "K1": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:235"),
    "K2": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:287"),
    "K3": ("plonkathon_tpu_torch/csrc/msm3.cu", "plonkathon_tpu/ops/msm3.py:152"),
    "K4": ("plonkathon_tpu_torch/csrc/msm3.cu", "plonkathon_tpu/ops/msm3.py:171"),
    "K5": ("plonkathon_tpu_torch/csrc/msm.cu", "plonkathon_tpu/ops/msm2.py:126"),
    "K6": ("plonkathon_tpu_torch/csrc/msm.cu", "plonkathon_tpu/ops/msm2.py:55"),
    "K7": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:463"),
    "K8a": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:445"),
    "K8b": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:454"),
    "K9": ("plonkathon_tpu_torch/csrc/mont.cu", "plonkathon_tpu/ops/pallas_mont.py:277"),
}

# The kernels each phase's path must launch.  Small circuits commit through
# msm2 (K5, K6, K7) and transform through the Stockham NTT; from m = 8192 /
# n = 2^14 up the path is msm3 (K3, K4, its K5 fold, K7 tables) and the
# four-step NTT, and K6 runs only on msm3's overflow fallback -- which the
# mul-chain's verification key takes once: its one public input makes QL
# the values [1, 0, 0, ...], n equal coefficients 1/n, so every window's
# digit fills a single bucket.  K8a ("K8a", its window sum) sums
# Setup.generate's windows in one launch; the elementwise K8a ("K8a add"),
# K8b and K9 have no caller and run in phase 3 alone.
_SMALL_PATH = ("K1 fr", "K1 fq", "K2", "K5", "K6", "K7")
_LARGE_PATH = ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K6", "K7", "K8a")
REQUIRED = {
    "kernels": ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K6", "K7", "K8a", "K8a add",
                "K8b", "K9"),
    "fixture": _SMALL_PATH,
    "chain-2^11": _SMALL_PATH,
    "chain-2^16": _LARGE_PATH,
    "chain-2^18": _LARGE_PATH,
    "msm3-oracle": ("K3", "K4", "K5"),
    "msm3-overflow": ("K3", "K4", "K5", "K6"),
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

def _muls(ops: tuple[int, int], count: int) -> int:
    """32-bit multiplies of `count` operations of (products, squarings)."""
    return count * (ops[0] * MULS_PER_MUL + ops[1] * MULS_PER_SQR)


def _bound(nbytes: int, muls: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT_MUL_PER_S * 1e3
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


def _real_point(torch, k: int):
    """The real G1 point k * G and its negation as stacked Jacobian [48, 1]
    (Z = 1)."""
    from plonkathon_tpu_torch.ec import G1, pt_mul, pt_neg
    from plonkathon_tpu_torch.ops.limbs import fq, to_device

    g = pt_mul(G1, k)
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
    p, neg_p = _real_point(torch, 0xC0FFEE)
    ident = torch.cat([p[:32], torch.zeros_like(p[32:])])
    for lane, (pa, pb) in enumerate(((ident, p), (p, ident), (p, p), (neg_p, p))):
        a[:, lane : lane + 1] = pa
        b[:, lane : lane + 1] = pb
    return a, b


def _packed(torch, np, rng, coords: int, w: int):
    """Random packed rows [8 * coords, w] (msm3 layout) of lazy Fq limbs."""
    from plonkathon_tpu_torch.ops import msm3
    from plonkathon_tpu_torch.ops.limbs import fq

    return msm3.pack_array(
        torch.cat([_lazy(torch, np, rng, fq, w, edges=False) for _ in range(coords)])
    )


def _plain_scan(torch, step, acc, pts, mask):
    """The plain one-step version applied over the steps (what a scan
    launch of K3 / K4 is held against)."""
    outs = []
    for s in range(mask.shape[0]):
        acc = step(acc, pts[s], mask[s])
        outs.append(acc)
    return torch.stack(outs)


def _inc_case(torch, np, rng, which: str, steps: int, w: int, values):
    """Inputs of a K3 ("madd") or K4 ("jadd") scan: random packed points and
    mask values drawn from `values`.  A scan's step 0 is fresh on every lane,
    as in the pipeline.  Lanes 0-3 hold real points: the accumulator P (set
    by step 0 in a scan), then Q under each of the kernel's four mask
    values."""
    from plonkathon_tpu_torch.ops import msm3

    coords = 2 if which == "madd" else 3
    pts = torch.stack([_packed(torch, np, rng, coords, w) for _ in range(steps)])
    acc = _packed(torch, np, rng, 3, w)
    mask = np.asarray(values)[rng.integers(0, len(values), size=(steps, w))]
    p, _ = _real_point(torch, 0xC0FFEE)
    q, _ = _real_point(torch, 0xBEEF)
    if steps > 1:
        mask[0] = 1
        pts[0, :, :4] = msm3.pack_array(p[: 16 * coords])
    else:
        acc[:, :4] = msm3.pack_array(p)
    edge_step = min(1, steps - 1)
    pts[edge_step, :, :4] = msm3.pack_array(q[: 16 * coords])
    mask[edge_step, :4] = [0, 1, 2, 3] if which == "madd" else [0, 1, 4, 5]
    return acc, pts, torch.from_numpy(mask.astype(np.int32)).to("cuda")


def _check_k3_decodes(torch, got):
    """K3's lanes 0-3 after step 1 are P + Q, Q, P - Q and -Q of real
    points: decode them and hold them against the host curve arithmetic."""
    from plonkathon_tpu_torch.ec import G1, pt_add, pt_mul, pt_neg
    from plonkathon_tpu_torch.ops import msm3
    from plonkathon_tpu_torch.ops.curve import jac_to_affine_host

    p, q = pt_mul(G1, 0xC0FFEE), pt_mul(G1, 0xBEEF)
    want = [pt_add(p, q), q, pt_add(p, pt_neg(q)), pt_neg(q)]
    limbs = msm3.unpack_array(got[1][:, :4])
    for lane in range(4):
        pt = jac_to_affine_host(tuple(limbs[16 * i : 16 * (i + 1), lane] for i in range(3)))
        if pt != want[lane]:
            fail(f"K3 lane {lane} (mask {lane}) does not decode to the expected point")


def _bucket_multiples(torch, w: int):
    """Stacked Jacobian [48, w] of real points: lane i holds (i + 1) * P,
    built by a ladder of K5 launches (lanes k..2k-1 = lanes 0..k-1 + k * P);
    every 61st lane is then emptied to the identity (Z = 0)."""
    from plonkathon_tpu_torch.ops import msm2

    arr, _ = _real_point(torch, 0xC0FFEE)
    while arr.shape[1] < w:
        k = arr.shape[1]
        arr = torch.cat([arr, msm2.jadd_stacked(arr, arr[:, k - 1 :].expand(-1, k))], dim=1)
    arr[32:, ::61] = 0
    return arr


def _check_fold_affine(torch, got):
    """The suffix fold of _bucket_multiples is sum_b b * (b * P) over the
    buckets b = i + 1 that were not emptied."""
    from plonkathon_tpu_torch.ec import G1, pt_mul
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.ops import msm3
    from plonkathon_tpu_torch.ops.curve import jac_to_affine_host

    k = sum((i + 1) ** 2 for i in range(msm3._NB2) if i % 61)
    want = pt_mul(G1, 0xC0FFEE * k % FR_MOD)
    if jac_to_affine_host(tuple(got[16 * i : 16 * (i + 1)] for i in range(3))) != want:
        fail("the msm3 suffix fold on the card does not decode to sum_b b * B_b")


def _ptxas(log: str, function: str) -> dict:
    """Registers, stack frame and spill bytes ptxas reported for the kernel
    `function` (matched in its mangled name)."""
    import re

    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and f"{len(function)}{function}" in line:
            text = " ".join(lines[i + 1 : i + 4])
            stack = re.search(r"(\d+) bytes stack frame", text)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            regs = re.search(r"Used (\d+) registers", text)
            if stack and spills and regs:
                return dict(registers=int(regs.group(1)), stack_bytes=int(stack.group(1)),
                            spill_bytes=int(spills.group(1)) + int(spills.group(2)))
    fail(f"no ptxas report for {function} in the build log")


def _dense_keys(np, rng, nb: int, t: int, J: int):
    """Sorted bucket keys [t] as the merge stage hands them to the dense
    stage: multiplicities from 0 to J (every value present, most buckets 1
    or 2), then the _BIG tail; returns (keys, multiplicities)."""
    from plonkathon_tpu_torch.ops import msm3

    mult = np.minimum(rng.poisson(1.5, size=nb), J)
    mult[: J + 1] = np.arange(J + 1)
    keys = np.repeat(np.arange(1, nb + 1), mult)
    if len(keys) > t:
        fail(f"dense-stage keys overflow T = {t}")
    keys = np.concatenate([keys, np.full(t - len(keys), msm3._BIG)])
    return keys.astype(np.int32), mult


def _scan_case(torch, np, rng, steps: int, chunks: int):
    """Inputs of a K6 scan as msm2 builds them: sorted 8-bit digits per
    chunk, prev shifted by one step, random affine bases; chunk 0 takes P
    at every step of one long run (the doubling branch)."""
    from plonkathon_tpu_torch.ops import msm2
    from plonkathon_tpu_torch.ops.limbs import fq

    dig = np.sort(rng.integers(0, msm2.NB, size=(chunks, steps)), axis=1)
    dig[0] = 7
    prev = np.concatenate([dig[:, :1], dig[:, :-1]], axis=1)
    d_t = torch.from_numpy(np.ascontiguousarray(dig.T, dtype=np.int32)).to("cuda")
    p_t = torch.from_numpy(np.ascontiguousarray(prev.T, dtype=np.int32)).to("cuda")
    pts = torch.stack([_lazy(torch, np, rng, fq, chunks, edges=False) for _ in range(2 * steps)])
    pts = pts.reshape(steps, 32, chunks)
    pts[:, :, 0] = _real_point(torch, 0xC0FFEE)[0][:32, 0]
    return d_t, p_t, pts


def _window_points(torch, np, rng, n: int):
    """Window-major Jacobian coordinates (X, Y, Z), each [16, 32, n], as
    Setup.generate's gather lays them out: random lazy coordinates, the
    identity (Z = 0) where a digit is 0 -- the digits drawn as the bytes
    of scalars below r fall, uniform in windows 0-30 and below r >> 248 + 1
    in window 31 -- and real points in points 0-3: P in every window
    (doublings at every level), P and -P alternating (cancellations, then
    identity + identity), P, Q, P, Q and then identities (a doubling of
    P + Q at level 2, with Z != 1), and identity + P, P + identity."""
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.ops.limbs import fq

    w = 32 * n
    stacked = torch.cat([_lazy(torch, np, rng, fq, w, edges=False) for _ in range(3)])
    stacked = stacked.reshape(48, 32, n)
    dig = rng.integers(0, 256, size=(32, n))
    dig[31] = rng.integers(0, (FR_MOD >> 248) + 1, size=n)
    stacked[32:, torch.from_numpy(dig == 0).to("cuda")] = 0
    p, neg_p = _real_point(torch, 0xC0FFEE)
    q, _ = _real_point(torch, 0xBEEF)
    ident = torch.cat([p[:32], torch.zeros_like(p[32:])])
    stacked[:, :, 0] = p
    stacked[:, :, 1] = torch.cat([p, neg_p], dim=1).repeat(1, 16)
    stacked[:, :, 2] = ident
    stacked[:, :4, 2] = torch.cat([p, q, p, q], dim=1)
    stacked[:, :4, 3] = torch.cat([ident, p, p, ident], dim=1)
    return tuple(stacked[16 * i : 16 * (i + 1)] for i in range(3))


def _window_adds(torch, win) -> int:
    """The adds of the window sum of `win` whose operands are both not the
    identity (an add with an identity operand multiplies nothing): the
    plain halving, counted level by level."""
    from plonkathon_tpu_torch.ops import cuda_mont as CM
    from plonkathon_tpu_torch.ops.limbs import fq_plain

    X, Y, Z = win
    adds = 0
    while X.shape[1] > 1:
        live = ~fq_plain.is_zero(Z[:, 0::2]) & ~fq_plain.is_zero(Z[:, 1::2])
        adds += int(live.sum())
        X, Y, Z = CM.jac_add_plain(
            (X[:, 0::2], Y[:, 0::2], Z[:, 0::2]), (X[:, 1::2], Y[:, 1::2], Z[:, 1::2])
        )
    return adds


def _scan_adds(torch, d_t, p_t, want) -> int:
    """The mixed adds of a K6 scan whose accumulator is not the identity,
    from its prefixes `want` [S, 48, C]: the first step and every fresh
    step add to the identity (no multiplies), as does a step after a
    prefix that cancelled."""
    from plonkathon_tpu_torch.ops.limbs import fq_plain

    live = ~fq_plain.is_zero(want[:-1, 32:].transpose(0, 1)) & (d_t[1:] == p_t[1:])
    return int(live.sum())


def check_kernels(torch, np) -> list[dict]:
    """Each kernel against its plain version on the card, at the shapes the
    headline (n = 2^18) path gives it: Setup.generate's window sum, the
    msm3 commits and four-step NTTs, and the one msm2 fallback commit at
    m = 2^18 (K6's scan, K5's widest chunk-fold level, K7's 8-doubling
    table step); the elementwise K8a, K8b and K9, which no path calls, at
    width 2^20, and K8a and K8b again at a ragged width on views."""
    from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm2, msm3
    from plonkathon_tpu_torch.ops.limbs import fq, fr

    n, reps = HEADLINE_N, 20
    rng = np.random.default_rng(20260817)
    cases = []

    # K1: fr at the quotient's 4n width, fq at the msm3 window tables' 16n.
    for field, ops, w in (("fr", fr, 4 * n), ("fq", fq, 16 * n)):
        a = _lazy(torch, np, rng, ops, w)
        b = _lazy(torch, np, rng, ops, w)
        b[:, :3] = b[:, 2:3]
        cases.append(dict(
            kernel=f"K1 {field}", fn="k1_kernel", name=f"K1 mont_mul ({field})", width=w,
            run=lambda f=field, a=a, b=b: CM.mont_mul(f, a, b),
            plain=lambda f=field, a=a, b=b: CM.mont_mul_plain(f, a, b),
            nbytes=3 * 64 * w, muls=_muls(OPS_FIELD, w),
        ))
    # K2: one four-step stage of the 4n coset NTT over the 15-polynomial stack.
    w = 15 * 2 * n
    c0, c1, tw = (_lazy(torch, np, rng, fr, w) for _ in range(3))
    cases.append(dict(
        kernel="K2", fn="k2_kernel", name="K2 dif_butterfly", width=w,
        run=lambda: CM.dif_butterfly(c0, c1, tw),
        plain=lambda: CM.dif_butterfly_plain(c0, c1, tw),
        nbytes=5 * 64 * w, muls=_muls(OPS_FIELD, w),
    ))
    # K3: the commit run-scan, S = 32 steps x C = 2^17 lanes, one launch.
    steps, lanes, _, t_ends, _ = msm3.plan_params(16 * n)
    acc3, pts3, mask3 = _inc_case(torch, np, rng, "madd", steps, lanes, [0, 1, 2, 3])
    cases.append(dict(
        kernel="K3", fn="k3_kernel", name="K3 madd_packed (run-scan)", width=steps * lanes,
        run=lambda: msm3._inc_scan("madd", acc3, pts3, mask3),
        plain=lambda: _plain_scan(torch, msm3.madd_packed_plain, acc3, pts3, mask3),
        nbytes=(164 * steps + 96) * lanes, muls=_muls(OPS_MADD, steps * lanes),
        after=_check_k3_decodes,
    ))
    # K4: the merge scan (16 steps x T/16 lanes, bit 0 only) and the dense-
    # bucket stage, all J rounds in one launch over T2 sorted run ends.
    w4 = t_ends // 16
    acc4, pts4, mask4 = _inc_case(torch, np, rng, "jadd", 16, w4, [0, 0, 0, 1])
    live = int(((mask4 & 5) == 0).sum())
    cases.append(dict(
        kernel="K4", fn="k4_kernel", name="K4 jadd_packed (merge scan)", width=16 * w4,
        run=lambda: msm3._inc_scan("jadd", acc4, pts4, mask4),
        plain=lambda: _plain_scan(torch, msm3.jadd_packed_plain, acc4, pts4, mask4),
        nbytes=(196 * 16 + 96) * w4, muls=_muls(OPS_JADD, live), profiled=True,
    ))
    t_dense = msm3.plan_params(16 * n)[4]
    keys, mult = _dense_keys(np, rng, msm3._NB2, t_dense, msm3._J)
    keys_d = torch.from_numpy(keys).to("cuda")
    pts_d = _packed(torch, np, rng, 3, t_dense)
    entries = int(mult.sum())
    cases.append(dict(
        kernel="K4", fn="k4_dense_kernel",
        name=f"K4 dense_buckets (all {msm3._J} rounds, one launch)", width=msm3._NB2,
        run=lambda: msm3._dense_buckets(keys_d, pts_d, msm3._J),
        plain=lambda: msm3._dense_buckets_plain(keys_d, pts_d, msm3._J),
        nbytes=4 * t_dense + 96 * entries + 192 * msm3._NB2,
        muls=_muls(OPS_JADD, int(np.maximum(mult - 1, 0).sum())),
        compare=lambda got, want: _max_err(torch, got[0], want[0])
        + abs(int(got[1]) - int(want[1])),
        profiled=True,
    ))
    # K5: the widest level of the msm2 fallback's chunk fold (NB * C / 2).
    k_msm = 32 * n  # the fallback commit's digit count: 32 windows x m = n
    chunks = msm2._choose_chunks(k_msm)
    w = msm2.NB * chunks // 2
    pa, pb = _points(torch, np, rng, w)
    cases.append(dict(
        kernel="K5", fn="k5_kernel", name="K5 jadd_stacked (msm2 chunk fold)", width=w,
        run=lambda: msm2.jadd_stacked(pa, pb),
        plain=lambda: msm2.jadd_stacked_plain(pa, pb),
        nbytes=3 * 192 * w, muls=_muls(OPS_JADD, w), profiled=True,
    ))
    # K5, the whole msm3 suffix fold of one commit (msm3.suffix_fold: one
    # launch) on a dense [48, 2^15] of real points, held against the same
    # fold run on CPU copies (the plain route, timed once) and, as an
    # affine point, against the host curve.  Its work: 3.5 W - 4 adds.
    dense = _bucket_multiples(torch, msm3._NB2)
    cases.append(dict(
        kernel="K5", fn="k5_fold_kernel", name="K5 suffix_fold (msm3 bucket fold, whole)",
        width=msm3._NB2,
        run=lambda: msm3.suffix_fold(dense),
        plain=lambda: msm3.suffix_fold(dense.cpu()).to("cuda"),
        nbytes=192 * (msm3._NB2 + 1), muls=_muls(OPS_JADD, 7 * msm3._NB2 // 2 - 4),
        plain_once=True, profiled=True, after=_check_fold_affine,
    ))
    # K6: the msm2 run-scan of the m = 2^18 fallback commit, S steps x C
    # chunks of sorted digits.  Its plain version loops the S steps on the
    # card in seconds: it is run once, compared and timed in that one call.
    steps6 = k_msm // chunks
    d_t, p_t, pts = _scan_case(torch, np, rng, steps6, chunks)
    cases.append(dict(
        kernel="K6", fn="k6_kernel", name="K6 run_scan", width=steps6 * chunks,
        run=lambda: msm2.run_scan(d_t, p_t, pts),
        plain=lambda: msm2.run_scan_plain(d_t, p_t, pts),
        nbytes=(8 + 128 + 192) * steps6 * chunks,
        muls=lambda want: _muls(OPS_MADD, _scan_adds(torch, d_t, p_t, want)),
        plain_once=True,
    ))
    # K7: one window step of a table build over n points: 16 doublings for
    # the msm3 tables, 8 for the msm2 tables the fallback builds.
    w = n
    p7a, _ = _points(torch, np, rng, w)
    pd = tuple(p7a[16 * i : 16 * (i + 1)] for i in range(3))
    for label, nd in (("msm3 tables", msm3.WBITS), ("msm2 tables", msm2.WINDOW_BITS)):
        cases.append(dict(
            kernel="K7", fn="k7_kernel", name=f"K7 jac_double_n ({label}, {nd} doublings)", width=w,
            run=lambda nd=nd: CM.jac_double_n(pd, nd),
            plain=lambda nd=nd: CM.jac_double_n_plain(pd, nd),
            nbytes=2 * 192 * w, muls=_muls(OPS_DOUBLE, nd * w),
        ))
    # K8a: Setup.generate(2^18)'s window sum, 32 windows of n points in one
    # launch: 31 n adds, of which the bound counts those with no identity
    # operand.  Its plain version halves level by level on the card.
    win = _window_points(torch, np, rng, n)
    cases.append(dict(
        kernel="K8a", fn="k8a_window_kernel", name="K8a window_sum (Setup.generate)",
        width=32 * n,
        run=lambda: CM.jac_window_sum(win), plain=lambda: CM.jac_window_sum_plain(win),
        nbytes=(3 * 64 * 32 + 192) * n, muls=_muls(OPS_JADD, _window_adds(torch, win)),
        profiled=True,
    ))
    # The elementwise K8a, K8b, K9: no path calls them; one representative width.
    w = 1 << 20
    qa, qb = _points(torch, np, rng, w)
    ca = tuple(qa[16 * i : 16 * (i + 1)] for i in range(3))
    cb = tuple(qb[16 * i : 16 * (i + 1)] for i in range(3))
    cases.append(dict(
        kernel="K8a add", fn="k8a_kernel", name="K8a jac_add", width=w,
        run=lambda: CM.jac_add(ca, cb), plain=lambda: CM.jac_add_plain(ca, cb),
        nbytes=3 * 192 * w, muls=_muls(OPS_JADD, w), profiled=True,
    ))
    cases.append(dict(
        kernel="K8b", fn="k8b_kernel", name="K8b jac_madd", width=w,
        run=lambda: CM.jac_madd(ca, cb[:2]), plain=lambda: CM.jac_madd_plain(ca, cb[:2]),
        nbytes=(192 + 128 + 192) * w, muls=_muls(OPS_MADD, w), profiled=True,
    ))
    e9, o9, t9 = (_lazy(torch, np, rng, fr, w) for _ in range(3))
    cases.append(dict(
        kernel="K9", fn="k9_kernel", name="K9 butterfly", width=w,
        run=lambda: CM.butterfly(e9, o9, t9), plain=lambda: CM.butterfly_plain(e9, o9, t9),
        nbytes=5 * 64 * w, muls=_muls(OPS_FIELD, w),
    ))

    log = cuda_lib.build_log()
    records = []
    for c in cases:
        kernel_id = c["kernel"]
        before = cuda_lib.LAUNCHES[kernel_id]
        got = c["run"]()
        torch.cuda.synchronize()
        per_call = cuda_lib.LAUNCHES[kernel_id] - before
        t0 = time.perf_counter()
        want = c["plain"]()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = c["compare"](got, want) if "compare" in c else _max_err(torch, got, want)
        if err != 0:
            fail(f"{c['name']} differs from its plain version (max abs err {err})")
        if "after" in c:
            c["after"](torch, got)
        muls = c["muls"](want) if callable(c["muls"]) else c["muls"]
        del want
        ms = _timed(torch, c["run"], reps)
        if not c.get("plain_once"):
            plain_ms = _timed(torch, c["plain"], 1)
        bound_ms, bound_by = _bound(c["nbytes"], muls)
        src, replaces = SOURCES[kernel_id.split()[0]]
        rec = dict(
            name=c["name"], kernel=kernel_id, route="cuda", source=src,
            replaces=replaces, width=c["width"], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=c["nbytes"], int_muls=muls, launches_per_call=per_call,
            library_ms=None, function=c["fn"], **_ptxas(log, c["fn"]),
        )
        records.append(rec)
        print(f"[3] {c['name']}: width {c['width']} equal raw limbs (max abs err "
              f"{err}, tolerance 0: integer arithmetic); kernel "
              f"{ms:.4f} ms, {per_call} launches a call, plain {plain_ms:.2f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); {c['fn']}: {rec['registers']} registers, "
              f"{rec['stack_bytes']} B stack, {rec['spill_bytes']} B spills", flush=True)
        del got
    # Device time under torch.profiler, taken after every CUDA-event timing
    # so that no profiled run comes before one.
    for c, rec in zip(cases, records):
        if c.get("profiled"):
            rec["device_ms"] = device_breakdown(torch, c["run"])["device_ms"]
            print(f"[3] {c['name']}: {rec['device_ms']:.4f} ms on the device "
                  f"(torch.profiler)", flush=True)
    # The elementwise adds once more, equality only, at a ragged width on
    # views that reach the kernels without a copy: p the first wr columns of
    # wider coordinates, q broadcast from [16, 1] (lane 2 of b, P: lanes 0-3
    # add identity + P, P + P twice and -P + P).
    wr = (1 << 10) + 37
    ra, rb = _points(torch, np, rng, 2 * wr)
    pv = tuple(ra[16 * i : 16 * (i + 1), :wr] for i in range(3))
    qv = tuple(rb[16 * i : 16 * (i + 1), 2:3] for i in range(3))
    for name, run, plain in (
        ("K8a jac_add", lambda: CM.jac_add(pv, qv), lambda: CM.jac_add_plain(pv, qv)),
        ("K8b jac_madd", lambda: CM.jac_madd(pv, qv[:2]), lambda: CM.jac_madd_plain(pv, qv[:2])),
    ):
        err = _max_err(torch, run(), plain())
        if err != 0:
            fail(f"{name} at width {wr} on views differs from its plain version "
                 f"(max abs err {err})")
        print(f"[3] {name}: width {wr}, p a column slice, q broadcast from [16, 1]: "
              f"equal raw limbs (max abs err {err})", flush=True)
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
        m = re.search(r"k\d[ab]?_(?:\w+_)?kernel", evt.name)
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
    """The launch counts since the last reset; fails unless every kernel
    that REQUIRED names for this phase's path was launched."""
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    missing = [k for k in REQUIRED[phase] if launches[k] == 0]
    if missing:
        fail(f"{phase}: kernels never launched on its path: {missing}")
    return launches


def synthetic_phase(ptt, torch, cuda_lib, n: int, phase: str, tag: str, profiled: bool):
    """Setup.generate(n) -> mul-chain -> prove -> verify, then a warm proof
    with its per-round times; returns (setup, launches over the path)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    setup = ptt.Setup.generate(n, tau=TAU)
    t_setup = time.perf_counter() - t0
    prover, witness, cold = chain_proof(ptt, setup, n)
    launches = launches_since_reset(torch, cuda_lib, phase)
    if launches["K8a"] != 1:
        fail(f"{phase}: Setup.generate's window sum took {launches['K8a']} K8a launches, not 1")
    peak = torch.cuda.max_memory_allocated()
    prover.timings = type(prover.timings)(prover.device)
    t0 = time.perf_counter()
    prover.prove(dict(witness))
    warm = time.perf_counter() - t0
    rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    print(f"{tag} mul-chain n = {n} on Setup.generate: verified; "
          f"setup {t_setup:.2f} s, cold prove {cold:.3f} s (window tables "
          f"included), warm prove {warm:.3f} s, warm rounds ms {json.dumps(rounds)}, "
          f"launches {json.dumps(launches)}, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if profiled:
        breakdown = device_breakdown(torch, lambda: prover.prove(dict(witness)))
        print(f"{tag} profiled warm prove: {json.dumps(breakdown)}", flush=True)
    return setup, launches


def msm_oracle_phase(torch, np, cuda_lib, setup, m: int):
    """msm3 commits at size m against p(tau) * G, on `setup`'s engine."""
    from plonkathon_tpu_torch.ec import G1, pt_mul
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.ops import msm3
    from plonkathon_tpu_torch.ops.limbs import fr, to_device

    eng = setup.msm_engine
    rng = np.random.default_rng(20260818)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(m)]
    coeffs[0], coeffs[1] = 0, FR_MOD - 1
    acc = 0
    for c in reversed(coeffs):  # Horner: p(tau)
        acc = (acc * TAU + c) % FR_MOD
    want_random = pt_mul(G1, acc)
    # All coefficients equal: each window's digit fills one bucket with
    # thousands of run ends, far more than the dense stage folds.
    c = int.from_bytes(rng.bytes(32), "little") % FR_MOD
    geometric = (pow(TAU, m, FR_MOD) - 1) * pow(TAU - 1, -1, FR_MOD) % FR_MOD
    want_equal = pt_mul(G1, c * geometric % FR_MOD)
    random_dev = to_device(fr.to_mont_host_many(coeffs), eng.device)
    equal_dev = to_device(fr.to_mont_host_many([c] * m), eng.device)

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    got = eng.commit_mont(random_dev)
    launches = launches_since_reset(torch, cuda_lib, "msm3-oracle")
    wall = time.perf_counter() - t0
    if got != want_random:
        fail(f"msm3 commit of {m} random coefficients differs from p(tau) * G")
    if launches["K6"] != 0:
        fail("a commit within msm3's multiplicity bound launched the msm2 scan")
    print(f"[8] msm3 commit, m = {m}, random coefficients (0 and r - 1 among them): "
          f"equals p(tau) * G; {wall * 1e3:.1f} ms; launches {json.dumps(launches)}",
          flush=True)

    cuda_lib.reset_launches()
    _, maxmult = eng.msm_mont_deferred(equal_dev)
    maxmult = int(maxmult)
    if maxmult <= msm3._J:
        fail(f"the crafted commit did not overflow: maxmult {maxmult}")
    got = eng.commit_mont(equal_dev)
    launches = launches_since_reset(torch, cuda_lib, "msm3-overflow")
    if got != want_equal:
        fail("the overflow commit (msm2 fallback) differs from its oracle")
    print(f"[8] msm3 overflow, m = {m}, all coefficients equal: maxmult {maxmult} > "
          f"{msm3._J}, recommitted through msm2, equals c * (tau^m - 1)/(tau - 1) * G; "
          f"launches {json.dumps(launches)}", flush=True)

    cuda_lib.reset_launches()
    got = eng.commit_batch([random_dev, equal_dev])
    launches = launches_since_reset(torch, cuda_lib, "msm3-overflow")
    if got != [want_random, want_equal]:
        fail("commit_batch of a normal and an overflowing polynomial differs")
    print(f"[8] commit_batch [random, overflow]: both equal their oracles; "
          f"launches {json.dumps(launches)}", flush=True)


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
    cuda_lib.reset_launches()
    records = check_kernels(torch, np)
    launches = launches_since_reset(torch, cuda_lib, "kernels")
    print(f"[3] launches of the comparisons {json.dumps(launches)}", flush=True)

    # 4. fixture proof, vkeys, golden commitment
    cuda_lib.reset_launches()
    fixture_phase(ptt)
    launches = launches_since_reset(torch, cuda_lib, "fixture")
    print(f"[4] fixture launches {json.dumps(launches)}", flush=True)

    # 5. mul-chain at n = 2^11 on the ceremony SRS (msm2 + Stockham)
    cuda_lib.reset_launches()
    setup11 = ptt.Setup.from_file(PTAU)
    _, _, wall11 = chain_proof(ptt, setup11, CHAIN_N)
    launches = launches_since_reset(torch, cuda_lib, "chain-2^11")
    if launches["K3"] or launches["K4"]:
        fail(f"n = {CHAIN_N} took the msm3 route: {launches}")
    print(f"[5] mul-chain n = {CHAIN_N} on the ceremony SRS: verified; "
          f"cold prove {wall11:.3f} s, launches {json.dumps(launches)}", flush=True)
    del setup11

    # 6. mul-chain at n = 2^16 on a synthetic SRS (msm3 + four-step)
    synthetic_phase(ptt, torch, cuda_lib, MID_N, "chain-2^16", "[6]", profiled=False)
    torch.cuda.empty_cache()

    # 7. headline: mul-chain at n = 2^18 on a synthetic SRS
    setup, launches = synthetic_phase(
        ptt, torch, cuda_lib, HEADLINE_N, "chain-2^18", "[7]", profiled=True
    )

    # 8. msm3 against the exact oracle, on the headline setup's engine
    msm_oracle_phase(torch, np, cuda_lib, setup, HEADLINE_N)

    for r in records:
        r["launches"] = launches[r["kernel"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
