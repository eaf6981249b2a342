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
     and the 32-window sum of 2^18 points (one K8a launch), K2's stage
     over round 3's stacks (15 rows for the chain, 27 for turbo + lookup,
     4 x 15 for phase 12's batch), K7's table steps and K8a's window sum
     again over 2^18 + 3 points (phase 10's SRS), and the
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
  6. a mul-chain proof at n = 2^14 on Setup.generate(2^14), verified
     (commits through msm3, NTTs through the four-step transform);
  7. the headline: a mul-chain proof at n = 2^18 on Setup.generate(2^18),
     verified, with per-round times, wall time, peak device memory and a
     profiled warm proof;
  8. msm3 commits at m = 2^18 against the exact oracle p(tau) * G (the
     synthetic SRS's tau is known): random coefficients, a crafted
     multiplicity overflow that must fall back to msm2, and both through
     commit_batch;
  9. TurboPlonK cube gates + PlonKup lookups (models/examples.py
     turbo_lookup_program): (a) the smallest such circuit on the ceremony
     SRS proved with debug checks on the card and on the CPU (the plain
     versions), the two proofs equal field for field, both verifiers
     accepting it and rejecting it with one lookup opening changed; (b) the
     circuit at n = 2^18 (2^18 - 8 gates, table_bits 8) on phase 7's SRS
     with a fresh commit engine (the cold proof builds its window tables),
     a cold and a warm proof and a profiled one, both verifiers accepting;
     the commits over msm3's multiplicity bound (msm2 fallback), read
     from K6's launches;
 10. ZK blinding (Program(blinding_rows=4)): (a) the three-gate circuit at
     n = 8 and the 12-gate turbo + lookup circuit at n = 16 on the
     ceremony SRS, proved with debug checks on the card and on the CPU
     under one seeded blinder stream (secrets.randbelow patched), the two
     proofs equal field for field, both verifiers accepting, and two
     unpatched card proofs differing in a_1, b_1, c_1, z_1; (b)
     Setup.generate(2^18 + 3) (its powers held against tau^i * G, the
     last three beyond n among them) and the blinded mul-chain at n = 2^18
     (n - 4 rows): cold, warm and profiled proofs, both verifiers, the
     msm3 tables' width (n + 3, built once) and K7's launches; (c) the
     rows of turbo_lookup_program(2^18 - 8, 2^18) with blinding rows on
     that SRS, an engine of its own: cold, warm, profiled, both
     verifiers, the msm2 fallback read from K6's launches;
 11. the standalone plookup (lookup.py): (a) the JAX tests' TABLE at
     n = 8 on the ceremony SRS, card against CPU field for field,
     verify_lookup accepting it and rejecting evals['f'] + 1; (b) the
     range table of 2^14 entries at n = 2^14 with seeded witness values
     on phase 7's SRS: prove and verify walls, the host Horner and
     synthetic division (profiler ranges), the q commit's route (m = 3n);
 12. BatchProver (parallel/batch.py): (a) the fixture circuit, B = 2:
     proof 0 is proof.pickle, proof 1 the single proof of its witness;
     (b) B = 4 mul-chain witnesses at n = 2^18 on phase 7's setup, each
     proof equal to its single proof, the batch's K2 launches no more
     than one single warm proof's, its wall against 4 single proofs and
     its peak memory;
 13. length-sharded proving on torch.distributed (parallel/sharded.py):
     (a) over NCCL, one rank per visible GPU (this process rank 0, a TCP
     store on the loopback), the mul-chain on phase 7's setup through
     Prover(config=ProverConfig(mesh=make_mesh())): cold and warm proofs
     equal to phase 7's single-device proof, verified, the collectives
     counted, Prover(), walls, rounds, peak and the twiddle tables' build;
     then on that mesh MeshMSM(setup.msm_engine, mesh, "shard").msm_mont
     of phase 8's 2^18 coefficients against the engine's msm_mont, and
     sharded_msm over the 2^18 SRS powers as Jacobian bases, five of them
     the identity, against the engine's commit of the same digits;
     (b) two spawned ranks sharing the card over Gloo (host-staged
     exchange): the chain at n = 2^14 against a single-device proof on
     the card, turbo + lookup at n = 16 against its single proof, and
     BatchProver(mesh=...) on the fixture (proof 0 is proof.pickle), the
     launch counts gathered from both ranks;
 14. the SRS checkpoint cache and the MSM entry points at n = 2^18, under
     a tempfile.mkdtemp() prefix removed at the end: (a)
     Setup.generate(2^18, srs_cache=...) writes its .gen file (one K8a
     launch), a second call reads it and launches nothing, the same SRS;
     (b) on that setup Prover(), a cold chain proof and the key build and
     write the msm3 and msm2 window tables; a fresh Setup.generate,
     Prover(), key and cold proof in the same cache launch no K7 and no
     K8a, the proof equal to phase 7's field for field and verified by
     both verifiers; walls against phase 7's, the files' sizes and their
     write and load times; (c) msm_variable_base over phase 7's SRS points
     (device limbs) and phase 8's random coefficients equals p(tau) * G
     on the msm3 route; (d) jac_fold_sum of width 0 on CUDA tensors is
     the identity, and over the first 2^18 - 5 powers as Jacobian points
     equals (1 + tau + ... + tau^(w-1)) * G, one elementwise K8a launch a
     level, its first level held against the plain add on CPU copies.
Each phase drives its path with the launch counts set to 0 just before and
read just after, prints its counts, and fails unless every kernel of ITS
path (REQUIRED below) was launched in it.
Lines "[t] phases ... done at X s" mark the wall clock between phases.
Then the total wall, nvidia-smi's name and power limit once more, one
JSON line of per-kernel records, and as the LAST line
{"ok": true, "device": {...}}.  Any failure exits non-zero without it.
Needs no network; imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
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
TURBO_SMALL = (12, 16, 3)  # gates, group order, table bits: 3 lookup rows
MID_N = 1 << 14     # phase 6 (cut from 2^16 to keep the smoke within 6 minutes)
CHAIN_N = 1 << 11
BLIND_ROWS = 4     # phase 10's blinding rows
BLIND_SEED = 20261017
PLOOKUP_N = 1 << 14  # phase 11(b) (cut from 2^16, as MID_N)
BATCH = 4          # phase 12's proofs per batch
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
# Setup.generate's windows in one launch; the elementwise K8a ("K8a add")
# is jac_fold_sum's add (phase 14(d)); K8b and K9 have no caller and run
# in phase 3 alone.
_SMALL_PATH = ("K1 fr", "K1 fq", "K2", "K5", "K6", "K7")
_LARGE_PATH = ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K6", "K7", "K8a")
REQUIRED = {
    "kernels": ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K6", "K7", "K8a", "K8a add",
                "K8b", "K9"),
    "fixture": _SMALL_PATH,
    "chain-2^11": _SMALL_PATH,
    "chain-2^14": _LARGE_PATH,
    "chain-2^18": _LARGE_PATH,
    "msm3-oracle": ("K3", "K4", "K5"),
    "msm3-overflow": ("K3", "K4", "K5", "K6"),
    # Phase 9 reuses phase 7's SRS, so no K8a; its own engine builds msm3
    # tables (K7); K6 only where a commit overflows msm3's multiplicity
    # bound.
    "turbo-lookup-2^18": ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K7"),
    # Phase 10: blinded proofs.  Its small circuits take the small path;
    # the chain generates its own n + 3 SRS (K8a), builds its tables (K7)
    # and, in the key, takes the QL fallback (K6); the blinded turbo +
    # lookup circuit has an engine of its own on that SRS.
    "zk-small": _SMALL_PATH,
    "zk-chain-2^18": _LARGE_PATH,
    "zk-turbo-lookup-2^18": ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K7"),
    # Phase 11: plookup at n = 8 (small path) and at n = 2^14 on phase 7's
    # engine, whose tables already cover 3n (no K7).
    "plookup-8": _SMALL_PATH,
    "plookup-2^14": ("K1 fr", "K2", "K3", "K4", "K5"),
    # Phase 12: BatchProver on the fixture (small path) and at n = 2^18 on
    # phase 7's engine (tables resident).
    "batch-8": _SMALL_PATH,
    "batch-2^18": ("K1 fr", "K2", "K3", "K4", "K5"),
    # Phase 13: the length-sharded chain proof.  Each rank's commit engine
    # builds msm3 tables over its slice of the SRS (K7) and commits n / D
    # >= 8192 coefficients through msm3; every local NTT is a Stockham one.
    "sharded-2^18": ("K1 fr", "K2", "K3", "K4", "K5", "K7"),
    "sharded-2rank": ("K1 fr", "K2", "K3", "K4", "K5", "K7"),
    # Phase 14: the cached path.  The cold Setup.generate sums its windows
    # (K8a); Prover(), the key (its QL takes the msm2 fallback: K6) and a
    # cold proof build the window tables (K7) and write them; the same on a
    # fresh setup in the same cache loads them: K7 and K8a stay 0 there.
    # msm_variable_base builds its own msm3 tables; jac_fold_sum adds a
    # level per elementwise K8a launch.
    "srs-cache-generate": ("K1 fq", "K8a"),
    "srs-cache-build": ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K6", "K7"),
    "srs-cache-hit": ("K1 fr", "K2", "K3", "K4", "K5", "K6"),
    "variable-base": ("K1 fq", "K3", "K4", "K5", "K7"),
    "fold-sum": ("K8a add",),
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


def chain_witness(n: int, a: int) -> dict:
    """chain_lines(n)'s witness for input a, c_i = a^(i+1) and out =
    a^(n-3), by repeated products (what fill_variable_assignments derives
    row by row, without its per-row parsing)."""
    from plonkathon_tpu_torch.fields import FR_MOD

    witness, acc = {"a": a}, a
    for i in range(1, n - 3):
        acc = acc * a % FR_MOD
        witness[f"c{i}"] = acc
    witness["out"] = acc * a % FR_MOD
    return witness


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
    table step), K2 over the chain's, turbo + lookup's and the B = 4
    batch's stacks, K7 and K8a's window sum again at n + 3 (phase 10's
    SRS); the elementwise K8a, K8b and K9, which no path calls, at width
    2^20, and K8a and K8b again at a ragged width on views."""
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
    # K2: one four-step stage of the 4n coset NTT over round 3's stack: 15
    # rows for the chain, 27 for turbo + lookup (15 + QCUBE + 11 lookup rows),
    # and B x 15 for phase 12's batch of B chain proofs.
    for rows, label in ((15, "15-row stack"), (27, "27-row stack"),
                        (BATCH * 15, f"batch stack, B = {BATCH} x 15 rows")):
        w = rows * 2 * n
        c0, c1, tw = (_lazy(torch, np, rng, fr, w) for _ in range(3))
        cases.append(dict(
            kernel="K2", fn="k2_kernel", name=f"K2 dif_butterfly ({label})", width=w,
            run=lambda c0=c0, c1=c1, tw=tw: CM.dif_butterfly(c0, c1, tw),
            plain=lambda c0=c0, c1=c1, tw=tw: CM.dif_butterfly_plain(c0, c1, tw),
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
    # the msm3 tables, 8 for the msm2 tables the fallback builds; and over
    # n + 3 points, the tables of phase 10's blinded proofs on an SRS of
    # n + 3 powers (a grid whose tail block is not full).
    for w, suffix in ((n, ""), (n + 3, ", width n + 3")):
        p7a, _ = _points(torch, np, rng, w)
        pd = tuple(p7a[16 * i : 16 * (i + 1)] for i in range(3))
        for label, nd in (("msm3 tables", msm3.WBITS), ("msm2 tables", msm2.WINDOW_BITS)):
            cases.append(dict(
                kernel="K7", fn="k7_kernel", width=w,
                name=f"K7 jac_double_n ({label}, {nd} doublings{suffix})",
                run=lambda pd=pd, nd=nd: CM.jac_double_n(pd, nd),
                plain=lambda pd=pd, nd=nd: CM.jac_double_n_plain(pd, nd),
                nbytes=2 * 192 * w, muls=_muls(OPS_DOUBLE, nd * w),
            ))
    # K8a: Setup.generate's window sum, 32 windows of n points in one
    # launch, for phase 7's 2^18 powers and phase 10's 2^18 + 3: 31 n adds,
    # of which the bound counts those with no identity operand.  Its plain
    # version halves level by level on the card.
    for w, label in ((n, "Setup.generate"), (n + 3, "Setup.generate, n + 3 points")):
        win = _window_points(torch, np, rng, w)
        cases.append(dict(
            kernel="K8a", fn="k8a_window_kernel", name=f"K8a window_sum ({label})",
            width=32 * w,
            run=lambda win=win: CM.jac_window_sum(win),
            plain=lambda win=win: CM.jac_window_sum_plain(win),
            nbytes=(3 * 64 * 32 + 192) * w, muls=_muls(OPS_JADD, _window_adds(torch, win)),
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
    with its per-round times; returns (setup, launches over the path, the
    prover, the witness, the warm proof, the cold prove wall s)."""
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
    proof = prover.prove(dict(witness))
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
    return setup, launches, prover, witness, proof, cold


def _oracle_coeffs(rng, m: int) -> list:
    """Phase 8's m random Fr coefficients, 0 and r - 1 first."""
    from plonkathon_tpu_torch.fields import FR_MOD

    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(m)]
    coeffs[0], coeffs[1] = 0, FR_MOD - 1
    return coeffs


def msm_oracle_phase(torch, np, cuda_lib, setup, m: int):
    """msm3 commits at size m against p(tau) * G, on `setup`'s engine;
    returns the random polynomial's device coefficients and p(tau) * G."""
    from plonkathon_tpu_torch.ec import G1, pt_mul
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.ops import msm3
    from plonkathon_tpu_torch.ops.limbs import fr, to_device

    eng = setup.msm_engine
    rng = np.random.default_rng(20260818)
    coeffs = _oracle_coeffs(rng, m)
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
    return random_dev, want_random


def _flat_ints(proof) -> dict:
    return {k: (tuple(int(c) for c in v) if isinstance(v, tuple) else int(v))
            for k, v in proof.flatten().items()}


def _lookup_eval_changed(proof):
    """The proof with its lk_f_eval opening increased by one."""
    from dataclasses import replace

    evals = dict(proof.msg_4.lookup_evals)
    evals["f"] = evals["f"] + 1
    return replace(proof, msg_4=replace(proof.msg_4, lookup_evals=evals))


def turbo_small_phase(ptt):
    """9(a): the smallest turbo + lookup circuit, card against CPU."""
    from plonkathon_tpu_torch.models.examples import turbo_lookup_program, turbo_lookup_witness

    t0 = time.perf_counter()
    gates, n, bits = TURBO_SMALL
    flats = {}
    for dev in ("cuda", "cpu"):
        setup = ptt.Setup.from_file(PTAU, device=dev)
        program = turbo_lookup_program(gates, n, table_bits=bits, device=dev)
        kinds = [bool(c.coeffs.get("$lookup")) + 2 * bool(c.coeffs.get("$cube"))
                 for c in program.constraints]
        if not (0 in kinds and 1 in kinds and 2 in kinds):
            fail("the small turbo + lookup circuit lacks vanilla, lookup or cube rows")
        proof = ptt.Prover(setup, program, debug=True, device=dev).prove(
            dict(turbo_lookup_witness(program)))
        flats[dev] = _flat_ints(proof)
        if dev == "cuda":
            vk = setup.verification_key(program.common_preprocessed_input())
            for verify in (vk.verify_proof, vk.verify_proof_unoptimized):
                if not verify(n, proof, []):
                    fail(f"the small turbo + lookup proof fails {verify.__name__}")
                if verify(n, _lookup_eval_changed(proof), []):
                    fail(f"{verify.__name__} accepts a changed lk_f_eval")
    if flats["cuda"] != flats["cpu"]:
        diff = sorted(k for k in flats["cuda"] if flats["cuda"][k] != flats["cpu"].get(k))
        fail(f"turbo + lookup proof: card and CPU differ in {diff}")
    print(f"[9a] turbo + lookup, {gates} gates at n = {n}, table_bits {bits}, debug checks: "
          f"the card's proof equals the CPU's field for field ({len(flats['cuda'])} fields); "
          f"both verifiers accept it and reject it with lk_f_eval + 1 "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


def turbo_large_phase(ptt, torch, cuda_lib, srs, n: int):
    """9(b): turbo_lookup_program(n - 8, n) on the SRS of `srs` (a Setup),
    with an engine of its own so that the cold proof builds its window
    tables: cold, warm and profiled proofs, both verifiers; returns the
    launches over its path."""
    from plonkathon_tpu_torch.models.examples import turbo_lookup_program, turbo_lookup_witness

    setup = ptt.Setup(srs.powers_of_x, srs.X2, device=srs.device)
    t0 = time.perf_counter()
    program = turbo_lookup_program(n - 8, n)
    witness = turbo_lookup_witness(program)
    t_build = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    prover = ptt.Prover(setup, program)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    cold = time.perf_counter() - t0
    cold_rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    prover.timings = type(prover.timings)(prover.device)
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    warm = time.perf_counter() - t0
    rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    vk = setup.verification_key(prover.pk)
    t_vk = time.perf_counter() - t0
    launches = launches_since_reset(torch, cuda_lib, "turbo-lookup-2^18")
    t0 = time.perf_counter()
    for verify in (vk.verify_proof, vk.verify_proof_unoptimized):
        if not verify(n, proof, []):
            fail(f"the n = {n} turbo + lookup proof fails {verify.__name__}")
    t_verify = time.perf_counter() - t0
    flat = proof.flatten()
    if len(flat) != 27 or any(v is None for v in flat.values()):
        fail(f"the n = {n} turbo + lookup proof has {len(flat)} fields or an identity")
    host = rounds.get("round_1_lookup_host", 0.0)
    print(f"[9b] turbo + lookup n = {n} ({n - 8} gates, table_bits 8) on Setup.generate: "
          f"both verifiers accept; program + witness {t_build:.2f} s, Prover() {t_init:.2f} s, "
          f"cold prove {cold:.3f} s (rounds ms {json.dumps(cold_rounds)}), warm prove "
          f"{warm:.3f} s (window tables built in the cold one), warm rounds ms {json.dumps(rounds)}, round 1's host f/h1/h2 build "
          f"{host:.1f} ms of round 1's {rounds['round_1']:.1f} ms; verification key {t_vk:.2f} s, "
          f"both verifiers {t_verify:.2f} s; peak device memory {peak / 2**30:.2f} GiB; "
          f"launches over the two proofs and the key {json.dumps(launches)}", flush=True)
    breakdown = device_breakdown(torch, lambda: prover.prove(dict(witness)))
    print(f"[9b] profiled warm prove: {json.dumps(breakdown)}", flush=True)
    # A commit over msm3's multiplicity bound is recommitted through msm2,
    # whose run-scan is K6: no K6 launch on this path means no fallback.
    fallback = "none" if launches["K6"] == 0 else f"{launches['K6']} K6 launches"
    print(f"[9b] commits that took the msm2 fallback (msm3's multiplicity bound): "
          f"{fallback}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phases 10-12: ZK blinding, the standalone plookup, BatchProver.
# ---------------------------------------------------------------------------

def turbo_lookup_lines(n_gates: int) -> list[str]:
    """The rows of models/examples.py's turbo_lookup_program (a quarter
    lookup rows into the table, the rest cube rows and every third a
    mul-add row), for circuits built here with blinding rows, which that
    function does not take."""
    nlk = n_gates // 4
    lines = [f"t{j} lookup" for j in range(nlk)]
    for i in range(n_gates - nlk):
        if i % 3 == 2:
            lines.append(f"y{i+1} <== y{i} * t{i % nlk} + y{i}")
        else:
            lines.append(f"y{i+1} <== y{i} * y{i} * y{i}")
    return lines


def blinded_turbo_program(ptt, n_gates: int, n: int, bits: int, device="cuda"):
    return ptt.Program(turbo_lookup_lines(n_gates), n, custom_gates=True,
                       lookup_table=list(range(1 << bits)), blinding_rows=BLIND_ROWS,
                       device=device)


@contextlib.contextmanager
def seeded_blinders(seed: int):
    """secrets.randbelow, through which the prover draws every blinder,
    replaced by one seeded stream; restored on exit."""
    import random
    import secrets

    real, stream = secrets.randbelow, random.Random(seed)
    secrets.randbelow = lambda bound: stream.randrange(bound)
    try:
        yield
    finally:
        secrets.randbelow = real


def zk_small_phase(ptt, torch, cuda_lib):
    """10(a): blinded proofs at n = 8 and 16 on the ceremony SRS under one
    seeded blinder stream, card against CPU; two unpatched card proofs of
    one witness differ."""
    from plonkathon_tpu_torch.models.examples import turbo_lookup_witness

    gates, n16, bits = TURBO_SMALL
    cases = {
        "three-gate n = 8": (
            lambda dev: ptt.Program(["e public", "c <== a * b", "e <== c * d"], 8,
                                    blinding_rows=BLIND_ROWS, device=dev),
            lambda program: {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}, [60]),
        f"turbo + lookup, {gates} gates at n = {n16}": (
            lambda dev: blinded_turbo_program(ptt, gates, n16, bits, dev),
            turbo_lookup_witness, []),
    }
    for name, (make, witness_of, public) in cases.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        flats = {}
        for dev in ("cuda", "cpu"):
            setup = ptt.Setup.from_file(PTAU, device=dev)
            program = make(dev)
            n = program.group_order
            witness = witness_of(program)
            prover = ptt.Prover(setup, program, debug=True, device=dev)
            cuda_lib.reset_launches()
            with seeded_blinders(BLIND_SEED):
                proof = prover.prove(dict(witness))
            flats[dev] = _flat_ints(proof)
            if dev == "cpu":
                continue
            launches = launches_since_reset(torch, cuda_lib, "zk-small")
            vk = setup.verification_key(program.common_preprocessed_input())
            for verify in (vk.verify_proof, vk.verify_proof_unoptimized):
                if not verify(n, proof, public):
                    fail(f"blinded {name}: the card's proof fails {verify.__name__}")
            again = [_flat_ints(prover.prove(dict(witness))) for _ in range(2)]
            same = [k for k in ("a_1", "b_1", "c_1", "z_1") if again[0][k] == again[1][k]]
            if same:
                fail(f"blinded {name}: two unpatched proofs agree in {same}")
        if flats["cuda"] != flats["cpu"]:
            diff = sorted(k for k in flats["cuda"] if flats["cuda"][k] != flats["cpu"].get(k))
            fail(f"blinded {name}: card and CPU differ under one blinder stream in {diff}")
        print(f"[10a] blinded {name}, blinding_rows {BLIND_ROWS}, debug checks: under one "
              f"seeded blinder stream the card's proof equals the CPU's field for field "
              f"({len(flats['cuda'])} fields); both verifiers accept it; two unpatched card "
              f"proofs differ in a_1, b_1, c_1, z_1; card launches "
              f"{json.dumps(launches)}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)


def zk_chain_phase(ptt, torch, cuda_lib, n: int):
    """10(b): Setup.generate(n + 3) (the blinded commits are n + 3 wide),
    its SRS against the host, and the mul-chain with blinding rows at
    n: cold, warm and profiled proofs, both verifiers; returns (setup,
    launches over the path)."""
    from plonkathon_tpu_torch.ec import G1, pt_mul
    from plonkathon_tpu_torch.fields import FR_MOD

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    setup = ptt.Setup.generate(n + 3, tau=TAU)
    t_setup = time.perf_counter() - t0
    for i in (0, 1, 2, n - 1, n, n + 1, n + 2):
        if setup.powers_of_x[i] != pt_mul(G1, pow(TAU, i, FR_MOD)):
            fail(f"Setup.generate({n} + 3): power {i} differs from tau^{i} * G")
    # chain_lines(n - 2) has n - 4 rows: all the rows the 4 blinding rows leave.
    program = ptt.Program(chain_lines(n - 2), n, blinding_rows=BLIND_ROWS)
    witness = program.fill_variable_assignments({"a": 3})
    prover = ptt.Prover(setup, program)
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    cold = time.perf_counter() - t0
    k7_cold = cuda_lib.LAUNCHES["K7"]
    prover.timings = type(prover.timings)(prover.device)
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    warm = time.perf_counter() - t0
    rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    peak_proofs = torch.cuda.max_memory_allocated()
    vk = setup.verification_key(program.common_preprocessed_input())
    peak = torch.cuda.max_memory_allocated()
    launches = launches_since_reset(torch, cuda_lib, "zk-chain-2^18")
    if launches["K8a"] != 1:
        fail(f"Setup.generate({n} + 3)'s window sum took {launches['K8a']} K8a launches, not 1")
    t0 = time.perf_counter()
    for verify in (vk.verify_proof, vk.verify_proof_unoptimized):
        if not verify(n, proof, [witness["out"]]):
            fail(f"the blinded n = {n} mul-chain proof fails {verify.__name__}")
    t_verify = time.perf_counter() - t0
    eng = setup.msm_engine
    # The proof's commits (m = n, n + 2, n + 3) take msm3 from m = 8192 up.
    width = eng._tab16_n if n >= eng._MSM3_MIN else eng._tab_n
    if width != n + 3:
        fail(f"the window tables are {width} wide, not n + 3 = {n + 3}")
    print(f"[10b] blinded mul-chain n = {n} ({n - 4} rows + {BLIND_ROWS} blinding rows) on "
          f"Setup.generate({n} + 3), its powers 0-2 and n - 1 ... n + 2 equal to tau^i * G: "
          f"both verifiers accept ({t_verify:.2f} s); setup {t_setup:.2f} s, cold prove "
          f"{cold:.3f} s, warm prove {warm:.3f} s, warm rounds ms {json.dumps(rounds)}; msm3 "
          f"tables {width} wide, built once (K7 {k7_cold} launches in the cold proof, "
          f"15 per build); peak device memory {peak_proofs / 2**30:.2f} GiB over setup and "
          f"proofs, {peak / 2**30:.2f} GiB with the key (its QL takes the msm2 fallback); "
          f"launches {json.dumps(launches)}", flush=True)
    breakdown = device_breakdown(torch, lambda: prover.prove(dict(witness)))
    print(f"[10b] profiled warm prove: {json.dumps(breakdown)}", flush=True)
    return setup, launches


def zk_turbo_phase(ptt, torch, cuda_lib, srs, n: int, bits: int = 8):
    """10(c): turbo_lookup_program(n - 8, n)'s rows with blinding rows, on
    the SRS of `srs` with an engine of its own (the cold proof builds its
    tables): cold, warm and profiled proofs, both verifiers; returns the
    launches over its path."""
    from plonkathon_tpu_torch.models.examples import turbo_lookup_witness

    setup = ptt.Setup(srs.powers_of_x, srs.X2, device=srs.device)
    t0 = time.perf_counter()
    program = blinded_turbo_program(ptt, n - 8, n, bits)
    witness = turbo_lookup_witness(program)
    t_build = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    prover = ptt.Prover(setup, program)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    cold = time.perf_counter() - t0
    cold_rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    prover.timings = type(prover.timings)(prover.device)
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    warm = time.perf_counter() - t0
    rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    peak = torch.cuda.max_memory_allocated()
    vk = setup.verification_key(prover.pk)
    launches = launches_since_reset(torch, cuda_lib, "zk-turbo-lookup-2^18")
    t0 = time.perf_counter()
    for verify in (vk.verify_proof, vk.verify_proof_unoptimized):
        if not verify(n, proof, []):
            fail(f"the blinded n = {n} turbo + lookup proof fails {verify.__name__}")
    t_verify = time.perf_counter() - t0
    flat = proof.flatten()
    if len(flat) != 27 or any(v is None for v in flat.values()):
        fail(f"the blinded n = {n} turbo + lookup proof has {len(flat)} fields or an identity")
    fallback = "none" if launches["K6"] == 0 else f"{launches['K6']} K6 launches"
    print(f"[10c] blinded turbo + lookup n = {n} ({n - 8} gates, table_bits {bits}, {BLIND_ROWS} "
          f"blinding rows) on phase 10(b)'s SRS: both verifiers accept ({t_verify:.2f} s); "
          f"program + witness {t_build:.2f} s, Prover() {t_init:.2f} s, cold prove {cold:.3f} s "
          f"(rounds ms {json.dumps(cold_rounds)}), warm prove {warm:.3f} s, warm rounds ms "
          f"{json.dumps(rounds)}; round 1 commits A, B, C (m = n) and the blinded f, h1, h2 "
          f"(m = n + 2, n + 3, n + 3) in one commit_batch, round 2 the blinded Z and Z2 "
          f"(m = n + 3); msm3 tables {setup.msm_engine._tab16_n} wide; commits that took the "
          f"msm2 fallback: {fallback}; peak device memory {peak / 2**30:.2f} GiB; launches over "
          f"the two proofs and the key {json.dumps(launches)}", flush=True)
    breakdown = device_breakdown(torch, lambda: prover.prove(dict(witness)))
    print(f"[10c] profiled warm prove: {json.dumps(breakdown)}", flush=True)
    return launches


def _lookup_ints(proof) -> dict:
    out = {k: tuple(int(c) for c in getattr(proof, k))
           for k in ("f_1", "h1_1", "h2_1", "z_1", "q_1", "W_z_1", "W_zw_1")}
    out.update({f"eval_{k}": int(v) for k, v in proof.evals.items()})
    return out


def _f_eval_changed(proof):
    from dataclasses import replace

    from plonkathon_tpu_torch.fields import FR_MOD

    return replace(proof, evals={**proof.evals, "f": (proof.evals["f"] + 1) % FR_MOD})


def plookup_small_phase(ptt, torch, cuda_lib):
    """11(a): the standalone plookup at n = 8 on the ceremony SRS, card
    against CPU (no randomness: equal field for field)."""
    from plonkathon_tpu_torch.lookup import prove_lookup, verify_lookup

    t0 = time.perf_counter()
    table, witness = [1, 5, 7, 11, 13, 17, 19, 23], [5, 13, 1, 5, 23, 7, 7]
    torch.cuda.reset_peak_memory_stats()
    flats = {}
    for dev in ("cuda", "cpu"):
        setup = ptt.Setup.from_file(PTAU, device=dev)
        cuda_lib.reset_launches()
        proof = prove_lookup(setup, table, witness)
        flats[dev] = _lookup_ints(proof)
        if dev == "cuda":
            launches = launches_since_reset(torch, cuda_lib, "plookup-8")
            if not verify_lookup(setup, table, proof):
                fail("verify_lookup rejects the card's n = 8 plookup proof")
            if verify_lookup(setup, table, _f_eval_changed(proof)):
                fail("verify_lookup accepts the n = 8 plookup proof with evals['f'] + 1")
    if flats["cuda"] != flats["cpu"]:
        diff = sorted(k for k in flats["cuda"] if flats["cuda"][k] != flats["cpu"][k])
        fail(f"plookup n = 8: card and CPU differ in {diff}")
    print(f"[11a] plookup n = 8 (the JAX tests' TABLE) on the ceremony SRS: the card's proof "
          f"equals the CPU's field for field ({len(flats['cuda'])} fields); verify_lookup "
          f"accepts it and rejects it with evals['f'] + 1; card launches "
          f"{json.dumps(launches)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


def host_ranges(torch, fn, names) -> dict:
    """ms of host time in the profiler ranges `names` during fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = {name: 0.0 for name in names}
    for evt in prof.events():
        if evt.name in got:
            got[evt.name] += evt.time_range.elapsed_us() / 1e3
    return got


def plookup_large_phase(ptt, torch, np, cuda_lib, setup, n: int):
    """11(b): the range table of n = PLOOKUP_N entries and n - 1 seeded witness
    values on `setup` (phase 7's 2^18 SRS: 3n powers for the quotient);
    returns the launches over the proof."""
    from plonkathon_tpu_torch.lookup import prove_lookup, verify_lookup
    from plonkathon_tpu_torch.ops.curve import FixedBaseMSM

    rng = np.random.default_rng(BLIND_SEED)
    table = list(range(n))
    witness = rng.integers(0, n, size=n - 1).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    proof = prove_lookup(setup, table, witness)
    t_prove = time.perf_counter() - t0
    launches = launches_since_reset(torch, cuda_lib, "plookup-2^14")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ok = verify_lookup(setup, table, proof)
    t_verify = time.perf_counter() - t0
    if not ok:
        fail(f"verify_lookup rejects the n = {n} plookup proof")
    if verify_lookup(setup, table, _f_eval_changed(proof)):
        fail(f"verify_lookup accepts the n = {n} plookup proof with evals['f'] + 1")
    names = ("plookup_host_horner", "plookup_host_division")
    host = host_ranges(torch, lambda: prove_lookup(setup, table, witness), names)
    route = "msm3" if 3 * n >= FixedBaseMSM._MSM3_MIN else "msm2"
    fallback = "none" if launches["K6"] == 0 else f"{launches['K6']} K6 launches"
    print(f"[11b] plookup n = {n}, table range({n}), {n - 1} seeded witness values, on "
          f"phase 7's SRS: verify_lookup accepts (and rejects evals['f'] + 1); prove "
          f"{t_prove:.3f} s, verify {t_verify:.3f} s; host Horner over 3n coefficients "
          f"{host[names[0]]:.1f} ms, host synthetic division {host[names[1]]:.1f} ms (a "
          f"second, profiled proof); the q commit (m = 3n = {3 * n}) by {route}; commits "
          f"that took the msm2 fallback: {fallback}; peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(launches)}", flush=True)
    return launches


def batch_small_phase(ptt, torch, cuda_lib):
    """12(a): BatchProver over the fixture circuit, B = 2, on the card."""
    from plonkathon_tpu_torch.parallel.batch import BatchProver

    t0 = time.perf_counter()
    setup = ptt.Setup.from_file(PTAU)
    program = ptt.Program(["e public", "c <== a * b", "e <== c * d"], 8)
    witnesses = [{"a": 3, "b": 4, "c": 12, "d": 5, "e": 60},
                 {"a": 2, "b": 5, "c": 10, "d": 7, "e": 70}]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    proofs = BatchProver(setup, program).prove_batch([dict(w) for w in witnesses])
    launches = launches_since_reset(torch, cuda_lib, "batch-8")
    fixture = ptt.load_proof_pickle(os.path.join(FIXTURES, "proof.pickle")).flatten()
    if proofs[0].flatten() != fixture:
        fail("BatchProver: proof 0 of the fixture circuit is not proof.pickle")
    if proofs[1].flatten() != ptt.Prover(setup, program).prove(dict(witnesses[1])).flatten():
        fail("BatchProver: proof 1 differs from the single proof of its witness")
    print(f"[12a] BatchProver, fixture circuit, B = 2: proof 0 equals proof.pickle, proof 1 "
          f"the single proof of its witness, field for field; launches {json.dumps(launches)}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)


def batch_large_phase(ptt, torch, cuda_lib, prover, b: int):
    """12(b): B mul-chain witnesses at phase 7's n on phase 7's setup and
    program: the batch against B single proofs, field for field, and its
    K2 launches against one single warm proof's; returns the batch's
    launches."""
    from plonkathon_tpu_torch.parallel.batch import BatchProver

    program, n = prover.program, prover.group_order
    t0 = time.perf_counter()
    witnesses = [chain_witness(n, a) for a in (3, 5, 7, 11)[:b]]
    t_wit = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = BatchProver(prover.setup, program)
    t_init = time.perf_counter() - t0
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    single0 = prover.prove(dict(witnesses[0]))
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    single_launches = dict(cuda_lib.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    proofs = batch.prove_batch([dict(w) for w in witnesses])
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = launches_since_reset(torch, cuda_lib, "batch-2^18")
    if launches["K2"] > single_launches["K2"]:
        fail(f"the B = {b} batch took {launches['K2']} K2 launches, one single proof "
             f"{single_launches['K2']}")
    singles = [single0] + [prover.prove(dict(w)) for w in witnesses[1:]]
    for i, (got, want) in enumerate(zip(proofs, singles)):
        if got.flatten() != want.flatten():
            fail(f"BatchProver: proof {i} of the n = {n} batch differs from its single proof")
    vk = prover.setup.verification_key(batch.pk)
    for i in (0, b - 1):
        if not vk.verify_proof(n, proofs[i], [witnesses[i]["out"]]):
            fail(f"BatchProver: proof {i} of the n = {n} batch does not verify")
    print(f"[12b] BatchProver, mul-chain n = {n}, B = {b} on phase 7's setup: every proof "
          f"equals the single proof of its witness, field for field, the first and last "
          f"verify; batch {t_batch:.3f} s "
          f"against {b} x the single warm proof {t_single:.3f} s = {b * t_single:.3f} s; "
          f"peak device memory {peak / 2**30:.2f} GiB (phase 7's setup and tables resident); "
          f"witnesses {t_wit:.2f} s, BatchProver() {t_init:.2f} s; K2 launches batch "
          f"{launches['K2']}, one single proof {single_launches['K2']}; batch launches "
          f"{json.dumps(launches)}, single proof launches {json.dumps(single_launches)}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 13: length-sharded proving on torch.distributed.
# ---------------------------------------------------------------------------

SHARDED_2RANK_N = 1 << 14  # 13(b)'s chain (cut from 2^16 to keep the smoke within 380 s)
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    """A free loopback port for a process group's TCP store."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _join(ctx, what: str):
    """Join spawned ranks (a rank's failure raises here) within the
    phase's time limit."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            fail(f"{what}: ranks did not finish in {RANK_TIMEOUT_S} s")


def _missing_kernels(phase: str, launches: dict) -> list:
    return [k for k in REQUIRED[phase] if launches[k] == 0]


def mesh_msm_checks(torch, np, setup, mesh, coeffs) -> dict:
    """13(a)'s engine checks on the phase's mesh, run by every rank:
    MeshMSM(setup.msm_engine, mesh, "shard").msm_mont of phase 8's random
    polynomial (cold: the ranks' tables built in it; then warm) against
    the engine's own msm_mont, and sharded_msm over the SRS powers as
    Jacobian bases, five of them the identity, with random 8-bit digits,
    against the engine's commit of those digits with the identity lanes'
    set to 0.  Compared as affine points; returns the walls in s."""
    from plonkathon_tpu_torch.ops import curve
    from plonkathon_tpu_torch.ops.limbs import fr, to_device
    from plonkathon_tpu_torch.parallel.sharded import MeshMSM, sharded_msm

    eng = setup.msm_engine
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 4)
        return curve.jac_to_affine_host(out)

    mesh_eng = MeshMSM(eng, mesh, "shard")
    got_cold = timed("MeshMSM.msm_mont cold", lambda: mesh_eng.msm_mont(coeffs))
    got = timed("MeshMSM.msm_mont", lambda: mesh_eng.msm_mont(coeffs))
    want = timed("engine msm_mont", lambda: eng.msm_mont(coeffs))
    if not got_cold == got == want:
        fail(f"13(a): MeshMSM.msm_mont of {coeffs.shape[-1]} coefficients differs from the "
             f"single-device engine's")
    rng = np.random.default_rng(20261019)
    digits = rng.integers(0, 256, eng.n).astype(np.int32)
    ident = np.sort(rng.choice(eng.n, 5, replace=False))
    X, Y, Z = curve.jac_from_affine(*curve.points_to_device(setup.powers_of_x, eng.device))
    Z[:, torch.from_numpy(ident).to(eng.device)] = 0
    dev_digits = torch.from_numpy(digits).to(eng.device)
    got = timed("sharded_msm", lambda: sharded_msm(mesh, "shard", (X, Y, Z), dev_digits))
    digits[ident] = 0
    masked = to_device(fr.to_mont_host_many(digits.tolist()), eng.device)
    want = timed("engine msm_mont of the digits", lambda: eng.msm_mont(masked))
    if got != want:
        fail(f"13(a): sharded_msm over {eng.n} bases with identity lanes {ident.tolist()} "
             f"differs from the single-device commit")
    return walls


def _nccl_helper(i: int, world: int, port: int, n: int):
    """13(a)'s rank i + 1 on its own card: the same collectives as rank
    0, in the same order (the cold sharded chain proof, the launch
    gather, the warm proof), on its own Setup.generate(n)."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    import plonkathon_tpu_torch as ptt
    from plonkathon_tpu_torch.config import ProverConfig
    from plonkathon_tpu_torch.ops import cuda_lib
    from plonkathon_tpu_torch.parallel.distributed import init_distributed
    from plonkathon_tpu_torch.parallel.mesh import all_gather_object, make_mesh

    os.environ["LOCAL_RANK"] = str(i + 1)
    init_distributed(f"tcp://127.0.0.1:{port}", world, i + 1)
    mesh = make_mesh()
    setup = ptt.Setup.generate(n, tau=TAU)
    program = ptt.Program(chain_lines(n), n)
    witness = chain_witness(n, 3)
    cuda_lib.reset_launches()
    prover = ptt.Prover(setup, program, config=ProverConfig(mesh=mesh))
    prover.prove(dict(witness))
    all_gather_object(dict(cuda_lib.LAUNCHES), mesh, "shard")
    prover.prove(dict(witness))
    import numpy as np
    import torch

    from plonkathon_tpu_torch.ops.limbs import fr, to_device

    coeffs = _oracle_coeffs(np.random.default_rng(20260818), n)
    mesh_msm_checks(torch, np, setup, mesh, to_device(fr.to_mont_host_many(coeffs), setup.device))
    dist.destroy_process_group()


def sharded_nccl_phase(ptt, torch, np, cuda_lib, setup, program, witness, want, coeffs):
    """13(a): the mul-chain on phase 7's setup proved length-sharded over
    NCCL, one rank per visible GPU (this process is rank 0), through
    Prover(config=ProverConfig(mesh=make_mesh())): equal to phase 7's
    single-device proof `want` of the same witness, verified; Prover(),
    cold and warm walls, rounds, peak, collectives, the twiddle matrices'
    and permuted tables' build; then the mesh engine checks on the same
    mesh (`mesh_msm_checks`, phase 8's coefficients `coeffs`); returns the
    launches of Prover() and the cold proof, summed over the ranks."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from plonkathon_tpu_torch.config import ProverConfig
    from plonkathon_tpu_torch.parallel import sharded
    from plonkathon_tpu_torch.parallel.distributed import init_distributed
    from plonkathon_tpu_torch.parallel.mesh import all_gather_object, make_mesh

    n = program.group_order
    world = torch.cuda.device_count()
    port = _free_port()
    helpers = None
    if world > 1:
        helpers = mp.start_processes(_nccl_helper, args=(world, port, n), nprocs=world - 1,
                                     join=False, start_method="spawn")
    init_distributed(f"tcp://127.0.0.1:{port}", world, 0)
    mesh = make_mesh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    prover = ptt.Prover(setup, program, config=ProverConfig(mesh=mesh))
    t_init = time.perf_counter() - t0
    if not prover._sharded:
        fail(f"13(a): n = {n} over {world} ranks did not take the sharded path")
    t0 = time.perf_counter()
    proof = prover.prove(dict(witness))
    cold = time.perf_counter() - t0
    cold_rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    collectives = dict(cuda_lib.COLLECTIVES)
    torch.cuda.synchronize()
    per_rank = all_gather_object(dict(cuda_lib.LAUNCHES), mesh, "shard")
    for r, launches in enumerate(per_rank):
        missing = _missing_kernels("sharded-2^18", launches)
        if missing:
            fail(f"sharded-2^18: rank {r} never launched {missing}")
    launches = {k: sum(l[k] for l in per_rank) for k in per_rank[0]}
    if not collectives["all_to_all"] or not collectives["all_gather"]:
        fail(f"13(a): the sharded proof issued collectives {collectives}")
    peak = torch.cuda.max_memory_allocated()
    prover.timings = type(prover.timings)(prover.device)
    t0 = time.perf_counter()
    warm_proof = prover.prove(dict(witness))
    warm = time.perf_counter() - t0
    rounds = {k: round(v * 1e3, 1) for k, v in prover.timings.sections.items()}
    for name, got in (("cold", proof), ("warm", warm_proof)):
        if got.flatten() != want.flatten():
            fail(f"13(a): the {name} sharded proof differs from phase 7's single-device proof")
    vk = setup.verification_key(prover.pk)
    if not vk.verify_proof(n, proof, [witness["out"]]):
        fail("13(a): the sharded proof does not verify")
    # What the cold proof pays for the cached device tables.
    n1, n2 = sharded._factor(n, world)
    sharded._twiddle_matrix.cache_clear()
    sharded._perm_tables.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rows, cols, inverse in ((n1, n2, True), (4 * n2, n1, False), (n1, 4 * n2, True)):
        sharded._twiddles(mesh, "shard", rows, cols, inverse)
    torch.cuda.synchronize()
    t_tw = time.perf_counter() - t0
    block = sharded._block(mesh, "shard", 4 * n2)
    t0 = time.perf_counter()
    sharded._perm_tables(n1, n2, (block.start, block.stop), mesh.device)
    torch.cuda.synchronize()
    t_perm = time.perf_counter() - t0
    t0 = time.perf_counter()
    walls = mesh_msm_checks(torch, np, setup, mesh, coeffs)
    t_checks = time.perf_counter() - t0
    dist.destroy_process_group()
    if helpers is not None:
        _join(helpers, "13(a)")
    print(f"[13a] MeshMSM(setup.msm_engine, mesh, \"shard\").msm_mont of phase 8's {n} "
          f"coefficients equals the engine's msm_mont (cold, its rank tables built in it, and "
          f"warm); sharded_msm over the {n} SRS powers as Jacobian bases, five of them the "
          f"identity, equals the engine's commit of the digits with those lanes 0; walls s "
          f"{json.dumps(walls)}; {t_checks:.1f} s for these checks in all", flush=True)
    print(f"[13a] sharded mul-chain n = {n} over NCCL, {world} rank(s), one per visible GPU "
          f"(n1 = {n1}, n2 = {n2}): cold and warm proofs equal the single-device proof "
          f"(phase 7's in the smoke) field for field, verified; Prover() {t_init:.2f} s, cold prove "
          f"{cold:.3f} s (rank 0's msm3 tables over its {n // world} SRS points built in it; "
          f"rounds ms {json.dumps(cold_rounds)}), warm prove {warm:.3f} s, warm rounds ms "
          f"{json.dumps(rounds)}; twiddle matrices {t_tw * 1e3:.1f} ms, permuted coset tables "
          f"{t_perm * 1e3:.1f} ms to build (cached after the cold proof); collectives per proof "
          f"{json.dumps(collectives)}; rank 0's peak device memory {peak / 2**30:.2f} GiB (the "
          f"single-device prover's setup and tables resident); launches of Prover() and the cold proof, all ranks "
          f"{json.dumps(launches)}", flush=True)
    return launches


def _gloo_rank(rank: int, world: int, port: int, out_path: str):
    """13(b)'s rank on the one card over Gloo: the sharded mul-chain at
    SHARDED_2RANK_N against a single-device proof, the turbo + lookup
    circuit at n = 16 sharded against single, and BatchProver(mesh=...)
    on the fixture with B = 2; rank 0 writes the results to out_path."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import plonkathon_tpu_torch as ptt
    from plonkathon_tpu_torch.config import ProverConfig
    from plonkathon_tpu_torch.models.examples import turbo_lookup_program, turbo_lookup_witness
    from plonkathon_tpu_torch.ops import cuda_lib
    from plonkathon_tpu_torch.parallel.batch import BatchProver
    from plonkathon_tpu_torch.parallel.distributed import init_distributed
    from plonkathon_tpu_torch.parallel.mesh import all_gather_object, make_mesh

    init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = make_mesh()
    cuda_lib.build()  # both ranks at once: one build (the lock), here already built
    n = SHARDED_2RANK_N
    t0 = time.perf_counter()
    setup = ptt.Setup.generate(n, tau=TAU)
    program = ptt.Program(chain_lines(n), n)
    witness = chain_witness(n, 3)
    t_setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    prover = ptt.Prover(setup, program, config=ProverConfig(mesh=mesh))
    proof = prover.prove(dict(witness))
    torch.cuda.synchronize()
    t_sharded = time.perf_counter() - t0
    mine = (dict(cuda_lib.LAUNCHES), dict(cuda_lib.COLLECTIVES))
    t0 = time.perf_counter()
    prover.prove(dict(witness))
    t_warm = time.perf_counter() - t0
    counts = all_gather_object(mine, mesh, "shard")
    # The single-device proof on the card (rank 0) while rank 1 verifies.
    if rank == 0:
        same = proof.flatten() == ptt.Prover(setup, program).prove(dict(witness)).flatten()
    else:
        vk = setup.verification_key(program.common_preprocessed_input())
        same = vk.verify_proof(n, proof, [witness["out"]])
    chain_ok = all_gather_object(same, mesh, "shard")

    small = ptt.Setup.from_file(PTAU)
    tprog = turbo_lookup_program(*TURBO_SMALL[:2], table_bits=TURBO_SMALL[2])
    tw = turbo_lookup_witness(tprog)
    tproof = ptt.Prover(small, tprog, config=ProverConfig(mesh=mesh)).prove(dict(tw))
    turbo_ok = tproof.flatten() == ptt.Prover(small, tprog).prove(dict(tw)).flatten()

    fixture = ptt.Program(["e public", "c <== a * b", "e <== c * d"], 8)
    witnesses = [{"a": 3, "b": 4, "c": 12, "d": 5, "e": 60},
                 {"a": 2, "b": 5, "c": 10, "d": 7, "e": 70}]
    proofs = BatchProver(small, fixture, mesh=mesh).prove_batch([dict(w) for w in witnesses])
    pickle_ok = proofs[0].flatten() == ptt.load_proof_pickle(
        os.path.join(FIXTURES, "proof.pickle")).flatten()
    single1 = ptt.Prover(small, fixture).prove(dict(witnesses[1])).flatten()
    batch_ok = pickle_ok and proofs[1].flatten() == single1
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"setup_s": t_setup, "sharded_cold_s": t_sharded, "sharded_warm_s": t_warm,
                       "launches": [c[0] for c in counts], "collectives": [c[1] for c in counts],
                       "chain_equal_single": chain_ok[0], "chain_verified": chain_ok[1],
                       "turbo_equal_single": turbo_ok, "batch_ok": batch_ok}, f)
    dist.destroy_process_group()


def sharded_gloo_phase(torch):
    """13(b): two ranks sharing the one card over Gloo (every collective
    stages its CUDA tensor through the host); returns the launches of the
    sharded chain proofs, summed over the ranks."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "13b.json")
        ctx = mp.start_processes(_gloo_rank, args=(2, _free_port(), out_path), nprocs=2,
                                 join=False, start_method="spawn")
        _join(ctx, "13(b)")
        with open(out_path) as f:
            res = json.load(f)
    wall = time.perf_counter() - t0
    for r, launches in enumerate(res["launches"]):
        missing = _missing_kernels("sharded-2rank", launches)
        if missing:
            fail(f"sharded-2rank: rank {r} never launched {missing}")
    if not all(c["all_to_all"] and c["all_gather"] for c in res["collectives"]):
        fail(f"13(b): the sharded proofs issued collectives {res['collectives']}")
    for key, what in (("chain_equal_single", "the sharded chain proof differs from the single one"),
                      ("chain_verified", "the sharded chain proof does not verify"),
                      ("turbo_equal_single", "the sharded turbo + lookup proof differs from single"),
                      ("batch_ok", "BatchProver(mesh=...) proofs differ from proof.pickle / single")):
        if not res[key]:
            fail(f"13(b): {what}")
    launches = {k: sum(l[k] for l in res["launches"]) for k in res["launches"][0]}
    print(f"[13b] two ranks sharing cuda:0 over Gloo (host-staged exchange: each collective "
          f"copies its CUDA tensor to the host and back): the sharded mul-chain at n = "
          f"{SHARDED_2RANK_N} equals the single-device proof made on the card, verified; the "
          f"turbo + lookup circuit at n = {TURBO_SMALL[1]} sharded equals its single proof; "
          f"BatchProver(mesh=...), B = 2 on the fixture: proof 0 is proof.pickle, proof 1 the "
          f"single proof; per rank: Setup.generate + Program {res['setup_s']:.2f} s, Prover() + "
          f"cold sharded prove {res['sharded_cold_s']:.3f} s, warm {res['sharded_warm_s']:.3f} s, "
          f"collectives {json.dumps(res['collectives'][0])}, launches {json.dumps(res['launches'])};"
          f" phase wall {wall:.1f} s", flush=True)
    return launches



# ---------------------------------------------------------------------------
# Phase 14: the SRS checkpoint cache and the MSM entry points.
# ---------------------------------------------------------------------------

def _timed_calls(cls, name: str, log: list):
    """Wrap cls.name so that each call appends (args, seconds) to log."""
    real = getattr(cls, name)

    def wrapped(self, *args):
        t0 = time.perf_counter()
        out = real(self, *args)
        log.append((args, time.perf_counter() - t0))
        return out

    setattr(cls, name, wrapped)
    return real


def srs_cache_phase(ptt, torch, np, cuda_lib, setup, program, witness, want, cold7, oracle):
    """14: Setup(srs_cache=...) at phase 7's n on a fresh cache prefix (a)
    the .gen file; (b) the window-table files: a cached cold proof with no
    K7 and no K8a, equal to phase 7's `want`; (c) msm_variable_base on
    phase 7's SRS and phase 8's `oracle` (device coefficients, p(tau) *
    G); (d) jac_fold_sum.  Returns (launches of (b)'s cached run, launches
    of the whole phase)."""
    import shutil
    import tempfile

    from plonkathon_tpu_torch.ec import G1, pt_mul
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.ops import cuda_mont as CM
    from plonkathon_tpu_torch.ops import curve

    n = program.group_order
    total = dict.fromkeys(cuda_lib.LAUNCHES, 0)

    def count(phase: str) -> dict:
        launches = launches_since_reset(torch, cuda_lib, phase)
        for k in total:
            total[k] += launches[k]
        return launches

    tmp = tempfile.mkdtemp(prefix="srs_cache_")
    prefix = os.path.join(tmp, "srs")
    try:
        # (a) the synthetic SRS: written cold, then read.
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        first = ptt.Setup.generate(n, tau=TAU, srs_cache=prefix)
        t_gen = time.perf_counter() - t0
        launches = count("srs-cache-generate")
        if launches["K8a"] != 1:
            fail(f"14(a): the cold Setup.generate took {launches['K8a']} K8a launches, not 1")
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        loaded = ptt.Setup.generate(n, tau=TAU, srs_cache=prefix)
        t_hit = time.perf_counter() - t0
        torch.cuda.synchronize()
        if any(cuda_lib.LAUNCHES.values()):
            fail(f"14(a): the cached Setup.generate launched {json.dumps(cuda_lib.LAUNCHES)}")
        if loaded.powers_of_x != first.powers_of_x or loaded.X2 != first.X2:
            fail("14(a): the cached SRS differs from the generated one")
        gen_mb = os.path.getsize(f"{prefix}.gen{n}.npz") / 1e6
        print(f"[14a] Setup.generate({n}, srs_cache=...): cold {t_gen:.2f} s (K8a "
              f"{launches['K8a']}, writes .gen{n}.npz, {gen_mb:.1f} MB), cached {t_hit:.2f} s "
              f"with no launch, the same {n} powers and X2", flush=True)
        del first

        # (b) the window tables: built and written, then loaded.
        loads, saves = [], []
        real_load = _timed_calls(curve.FixedBaseMSM, "_load_tables", loads)
        real_save = _timed_calls(curve.FixedBaseMSM, "_save_tables", saves)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        prover = ptt.Prover(loaded, program)
        proof = prover.prove(dict(witness))
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        vk = loaded.verification_key(prover.pk)
        t_key = time.perf_counter() - t0
        launches = count("srs-cache-build")
        if proof.flatten() != want.flatten():
            fail("14(b): the proof that builds the tables differs from phase 7's")
        sizes = {f[len("srs."):]: round(os.path.getsize(os.path.join(tmp, f)) / 1e6, 1)
                 for f in sorted(os.listdir(tmp)) if ".affine" in f}
        if len(sizes) != 2:
            fail(f"14(b): expected an msm2 and an msm3 table file, found {sorted(sizes)}")
        write_s = [round(dt, 3) for _, dt in saves]
        k7_build = launches["K7"]
        del prover, vk, loaded
        torch.cuda.empty_cache()
        loads.clear()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        cached = ptt.Setup.generate(n, tau=TAU, srs_cache=prefix)
        t_gen_hit = time.perf_counter() - t0
        t0 = time.perf_counter()
        prover = ptt.Prover(cached, program)
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof = prover.prove(dict(witness))
        t_cold_hit = time.perf_counter() - t0
        t0 = time.perf_counter()
        vk = cached.verification_key(prover.pk)
        t_key_hit = time.perf_counter() - t0
        hit = count("srs-cache-hit")
        curve.FixedBaseMSM._load_tables, curve.FixedBaseMSM._save_tables = real_load, real_save
        if hit["K7"] or hit["K8a"]:
            fail(f"14(b): the cached run launched K7 {hit['K7']} and K8a {hit['K8a']} times")
        if len(loads) != 2 or len(saves) != 2:
            fail(f"14(b): {len(saves)} table writes and {len(loads)} cached loads, not 2 and 2")
        if proof.flatten() != want.flatten():
            fail("14(b): the cached cold proof differs from phase 7's proof")
        for verify in (vk.verify_proof, vk.verify_proof_unoptimized):
            if not verify(n, proof, [witness["out"]]):
                fail(f"14(b): the cached cold proof fails {verify.__name__}")
        load_s = {kind: round(dt, 3) for (kind, _), dt in loads}
        # The host's share of the msm2 table load: np.load alone.
        t0 = time.perf_counter()
        with np.load(f"{prefix}.affine{n}.npz") as data:
            host_mb = sum(data[k].nbytes for k in ("AX", "AY")) / 1e6
        t_npload = time.perf_counter() - t0
        print(f"[14b] mul-chain n = {n} on the cached setup: Prover() + cold prove "
              f"{t_cold:.3f} s and key {t_key:.2f} s building the tables (K7 {k7_build}; "
              f"written in {write_s} s); then a fresh Setup.generate {t_gen_hit:.2f} s, "
              f"Prover() {t_init:.2f} s, cold prove {t_cold_hit:.3f} s and key "
              f"{t_key_hit:.2f} s on the cached tables (phase 7's cold prove {cold7:.3f} s): "
              f"K7 {hit['K7']}, K8a {hit['K8a']}, the proof equal to phase 7's field for field, "
              f"both verifiers accept; table files MB {json.dumps(sizes)}, load s "
              f"{json.dumps(load_s)} (np.load alone of the msm2 tables' {host_mb:.1f} MB "
              f"{t_npload:.3f} s); launches of the cached run {json.dumps(hit)}", flush=True)
        del prover, vk, cached
        torch.cuda.empty_cache()

        # (c) msm_variable_base over phase 7's SRS points as device limbs.
        coeffs, want_pt = oracle
        x, y = curve.points_to_device(setup.powers_of_x, coeffs.device)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        got = curve.jac_to_affine_host(curve.msm_variable_base((x, y), coeffs))
        t_vb = time.perf_counter() - t0
        launches = count("variable-base")
        if got != want_pt:
            fail(f"14(c): msm_variable_base over {n} points differs from p(tau) * G")
        print(f"[14c] msm_variable_base, m = {n} (phase 7's SRS, phase 8's coefficients): "
              f"equals p(tau) * G; {t_vb:.3f} s with its msm3 tables; launches "
              f"{json.dumps(launches)}", flush=True)

        # (d) jac_fold_sum over w SRS powers, a width that is not a power of two.
        w = n - 5
        first_level = []
        real_add = curve.jac_add

        def first_add(p, q):  # keeps the first level's operands and sums
            out = real_add(p, q)
            if not first_level:
                first_level.append((p, q, out))
            return out

        curve.jac_add = first_add
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        total_pt = curve.jac_fold_sum(curve.jac_from_affine(x[:, :w], y[:, :w]))
        torch.cuda.synchronize()
        t_fold = time.perf_counter() - t0
        launches = count("fold-sum")
        curve.jac_add = real_add
        levels = (w - 1).bit_length()
        if launches["K8a add"] != levels:
            fail(f"14(d): {launches['K8a add']} elementwise K8a launches, not {levels}")
        s = (pow(TAU, w, FR_MOD) - 1) * pow(TAU - 1, -1, FR_MOD) % FR_MOD
        if curve.jac_to_affine_host(total_pt) != pt_mul(G1, s):
            fail(f"14(d): jac_fold_sum over {w} powers differs from (tau^w - 1)/(tau - 1) * G")
        p, q, out = first_level[0]
        t0 = time.perf_counter()
        plain = CM.jac_add_plain(tuple(c.cpu() for c in p), tuple(c.cpu() for c in q))
        t_plain = time.perf_counter() - t0
        err = max(_max_err(torch, o.cpu(), r) for o, r in zip(out, plain))
        if err != 0:
            fail(f"14(d): the fold's first level differs from the plain add (max abs err {err})")
        cuda_lib.reset_launches()
        empty = curve.jac_fold_sum(tuple(c[:, :0] for c in curve.jac_from_affine(x, y)))
        if curve.jac_to_affine_host(empty) is not None or not all(
                torch.equal(e, i) for e, i in zip(empty, curve.jac_identity((), x.device))):
            fail("14(d): jac_fold_sum of width 0 is not the identity")
        launched = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        if launched or not all(e.is_cuda for e in empty):
            fail(f"14(d): jac_fold_sum of width 0 launched {launched} or left the card")
        print("[14d] jac_fold_sum of width 0 on CUDA tensors: the identity (1, 1, 0) on the "
              "card, as the JAX package pads it to one identity; no launch", flush=True)
        print(f"[14d] jac_fold_sum over {w} powers: equals (tau^w - 1)/(tau - 1) * G; "
              f"{t_fold * 1e3:.1f} ms, {levels} elementwise K8a launches (one a level); its "
              f"first level ({p[0].shape[-1]} adds on column views) equal raw limbs to the plain "
              f"add on CPU copies (max abs err {err}, {t_plain:.2f} s); launches "
              f"{json.dumps(launches)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return hit, total


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

    def mark(phases: str):
        print(f"[t] phases {phases} done at {time.perf_counter() - T_START:.1f} s", flush=True)

    mark("1-3")

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

    # 6. mul-chain at n = 2^14 on a synthetic SRS (msm3 + four-step)
    synthetic_phase(ptt, torch, cuda_lib, MID_N, "chain-2^14", "[6]", profiled=False)
    torch.cuda.empty_cache()

    # 7. headline: mul-chain at n = 2^18 on a synthetic SRS
    setup, launches, chain_prover, chain_witness7, chain_proof7, cold7 = synthetic_phase(
        ptt, torch, cuda_lib, HEADLINE_N, "chain-2^18", "[7]", profiled=True
    )

    mark("4-7")

    # 8. msm3 against the exact oracle, on the headline setup's engine
    oracle8 = msm_oracle_phase(torch, np, cuda_lib, setup, HEADLINE_N)
    mark("8")

    # 9. TurboPlonK cube gates + PlonKup lookups: card against CPU, then
    # n = 2^18 on the headline setup
    turbo_small_phase(ptt)
    mark("9a")
    turbo_launches = turbo_large_phase(ptt, torch, cuda_lib, setup, HEADLINE_N)
    torch.cuda.empty_cache()

    # 10. ZK blinding: card against CPU under one blinder stream, then the
    # blinded chain and turbo + lookup circuits at n = 2^18 on an n + 3 SRS
    mark("9b")
    zk_small_phase(ptt, torch, cuda_lib)
    mark("10a")
    zk_setup, zk_chain_launches = zk_chain_phase(ptt, torch, cuda_lib, HEADLINE_N)
    zk_turbo_launches = zk_turbo_phase(ptt, torch, cuda_lib, zk_setup, HEADLINE_N)
    del zk_setup
    torch.cuda.empty_cache()

    # 11. the standalone plookup: card against CPU at n = 8, then n = 2^14
    # on the headline setup
    mark("10b-10c")
    plookup_small_phase(ptt, torch, cuda_lib)
    mark("11a")
    plookup_launches = plookup_large_phase(ptt, torch, np, cuda_lib, setup, PLOOKUP_N)

    # 12. BatchProver: the fixture, then B chain proofs at n = 2^18
    batch_small_phase(ptt, torch, cuda_lib)
    batch_launches = batch_large_phase(ptt, torch, cuda_lib, chain_prover, BATCH)
    mark("11b-12")

    # 13. length-sharded proving: the chain at n = 2^18 over NCCL, one rank
    # per visible GPU, then two ranks sharing the card over Gloo
    sharded_launches = sharded_nccl_phase(ptt, torch, np, cuda_lib, setup, chain_prover.program,
                                          chain_witness7, chain_proof7, oracle8[0])
    mark("13a")
    sharded2_launches = sharded_gloo_phase(torch)
    mark("13b")

    # 14. the SRS checkpoint cache and the MSM entry points at n = 2^18
    cache_hit_launches, cache_launches = srs_cache_phase(
        ptt, torch, np, cuda_lib, setup, chain_prover.program, chain_witness7, chain_proof7,
        cold7, oracle8)
    mark("14")

    for r in records:
        k = r["kernel"]
        r["launches"] = launches[k]
        r["launches_turbo_lookup"] = turbo_launches[k]
        r["launches_zk_chain"] = zk_chain_launches[k]
        r["launches_zk_turbo_lookup"] = zk_turbo_launches[k]
        r["launches_plookup"] = plookup_launches[k]
        r["launches_batch"] = batch_launches[k]
        r["launches_sharded"] = sharded_launches[k]
        r["launches_sharded_2rank"] = sharded2_launches[k]
        r["launches_srs_cache"] = cache_launches[k]
        r["launches_srs_cache_hit"] = cache_hit_launches[k]
    print(f"chip_smoke: total wall {time.perf_counter() - T_START:.1f} s", flush=True)
    print(smi, flush=True)  # again, where a tail of the output keeps it
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
