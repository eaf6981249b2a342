"""Fixed-base Pippenger MSM — the 8-bit sorted run-scan pipeline.

Counterpart of the JAX package's `ops/msm2.py`.  Two kernels live here
(CUDA C++ in `csrc/msm.cu`):

* K5 `jadd_stacked` — complete Jacobian add on stacked [48, W] points;
* K6 `run_scan`     — the per-chunk sorted-run bucket accumulation.

Pipeline for sum_i c_i * P_i over pre-shifted affine window tables (base w
of point i is 2^(8w) * P_i, so all 32 windows share one 256-bucket problem):

1. 8-bit digits, sorted; bases gathered into sorted order.
2. The sorted positions are cut into C chunks of S steps.  K6 walks each
   chunk, restarting at the identity where the digit changes, and writes
   the running prefix after every step.
3. Within a chunk the digits are sorted, so the last prefix of digit b sits
   at `searchsorted(chunk, b, right) - 1`: one gather extracts every
   (bucket, chunk) sum, no scatter.
4. The per-chunk buckets fold pairwise over the chunks (K5), then a suffix
   scan and a fold turn bucket sums into sum_b b * B_b.

Results are compared as affine points: the Jacobian triple depends on the
chunking, the affine point does not.
"""

from __future__ import annotations

import torch

from .limbs import fq, fq_plain, NLIMBS, DTYPE
from .cuda_lib import fn, check, stream_ptr, count_launch
from .cuda_mont import (
    _kern_add, _kern_madd, check_limbs, field_consts, jac_double_n,
    stack_points, unstack_points,
)

WINDOW_BITS = 8
NWINDOWS = 32
NB = 1 << WINDOW_BITS
_MAX_CHUNKS = 1 << 14
_STEP_ALIGN = 16


# ---------------------------------------------------------------------------
# K5: stacked complete add.
# ---------------------------------------------------------------------------

def jadd_stacked_plain(a, b):
    w = a.shape[-1]
    out = _kern_add(fq_plain, unstack_points(a, (w,)), unstack_points(b, (w,)))
    return stack_points(out, w)


def jadd_stacked(a, b):
    """Complete Jacobian add on stacked [48, W] coordinate arrays."""
    if not (a.is_cuda or b.is_cuda):
        return jadd_stacked_plain(a, b)
    a, b = check_limbs(3 * NLIMBS, a, b)
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"jadd_stacked: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    out = torch.empty_like(a)
    rc = fn("k5_jadd_stacked")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1],
        field_consts("fq"), stream_ptr(a.device),
    )
    count_launch("K5")
    check(rc, "k5_jadd_stacked")
    return out


# ---------------------------------------------------------------------------
# K6: sorted-run scan.
# ---------------------------------------------------------------------------

def _identity_stacked(w: int, device):
    one = fq.const("ONE_MONT", device, 2).expand(NLIMBS, w)
    return torch.cat([one, one, torch.zeros((NLIMBS, w), dtype=DTYPE, device=device)])


def run_scan_plain(dig, prev, pts):
    """dig/prev int32[S, C]; pts int32[S, 32, C] affine (x, y) ->
    int32[S, 48, C], the running prefix after every step."""
    steps, chunks = dig.shape
    k = fq_plain
    acc = unstack_points(_identity_stacked(chunks, dig.device), (chunks,))
    ident = acc
    outs = []
    for s in range(steps):
        fresh = dig[s] != prev[s]
        acc = tuple(k.select(fresh, i, a) for i, a in zip(ident, acc))
        acc = _kern_madd(k, acc, (pts[s, :NLIMBS], pts[s, NLIMBS:]))
        outs.append(torch.cat(acc, dim=0))
    return torch.stack(outs)


def run_scan(dig, prev, pts):
    """Per-chunk sorted-run accumulation (see `run_scan_plain`)."""
    if not (dig.is_cuda or prev.is_cuda or pts.is_cuda):
        return run_scan_plain(dig, prev, pts)
    steps, chunks = dig.shape
    if prev.shape != dig.shape or pts.shape != (steps, 2 * NLIMBS, chunks):
        raise ValueError("run_scan: expected dig/prev [S, C] and pts [S, 32, C]")
    if dig.dtype != DTYPE or prev.dtype != DTYPE or pts.dtype != DTYPE:
        raise ValueError("run_scan: operands must be int32")
    if not (dig.is_cuda and prev.is_cuda and pts.is_cuda):
        raise ValueError("run_scan: operands must all be on one CUDA device")
    dig, prev, pts = dig.contiguous(), prev.contiguous(), pts.contiguous()
    out = torch.empty((steps, 3 * NLIMBS, chunks), dtype=DTYPE, device=dig.device)
    rc = fn("k6_run_scan")(
        dig.data_ptr(), prev.data_ptr(), pts.data_ptr(), out.data_ptr(),
        steps, chunks, field_consts("fq"), stream_ptr(dig.device),
    )
    count_launch("K6")
    check(rc, "k6_run_scan")
    return out


# ---------------------------------------------------------------------------
# Bucket reduction.
# ---------------------------------------------------------------------------

def _fold_stacked(arr, add=jadd_stacked):
    """[48, ..., W] -> [48, ..., W/2] ... -> [48, ..., 1] by pairwise
    complete adds over the last axis."""
    w = arr.shape[-1]
    m = 1 << (w - 1).bit_length()
    if m != w:
        pad = _identity_stacked(m - w, arr.device)
        pad = pad.reshape((3 * NLIMBS,) + (1,) * (arr.ndim - 2) + (m - w,))
        arr = torch.cat([arr, pad.expand(arr.shape[:-1] + (m - w,))], dim=-1)
    while m > 1:
        half = m // 2
        lead = arr.shape[:-1]
        arr = add(arr[..., :half].reshape(3 * NLIMBS, -1),
                  arr[..., half:m].reshape(3 * NLIMBS, -1)).reshape(lead + (half,))
        m = half
    return arr


def _suffix_scan_stacked(arr):
    """Inclusive suffix sums over the last axis of [48, ..., w]:
    C_t = sum_{d>=t} B_d."""
    w = arr.shape[-1]
    steps = max((w - 1).bit_length(), 1)
    pos = torch.arange(w, device=arr.device)
    for j in range(steps):
        shift = 1 << j
        rolled = torch.roll(arr, -shift, dims=-1)
        valid = (pos < w - shift).to(DTYPE)
        rolled = torch.cat([rolled[: 2 * NLIMBS], rolled[2 * NLIMBS :] * valid], dim=0)
        arr = jadd_stacked(rolled.reshape(3 * NLIMBS, -1), arr.reshape(3 * NLIMBS, -1)).reshape(arr.shape)
    return arr


# ---------------------------------------------------------------------------
# Full MSM.
# ---------------------------------------------------------------------------

def _choose_chunks(k: int) -> int:
    """Chunk count C: a power of two near k/16, at most 2^14.

    K6 runs a thread pair per chunk for S = k/C dependent steps, so C sets
    its parallelism; the chunk fold costs NB * C complete adds and the
    bucket gather NB * C points.  At the n = 2^16 commit (k = 2^21) this
    gives C = 2^14 (248 threads per SM on 132 SMs) and S = 128.  Small commits
    (the 8-point fixture, k = 256) keep S = 16 steps."""
    target = max(1, min(_MAX_CHUNKS, k // _STEP_ALIGN))
    return 1 << (target.bit_length() - 1)


def _msm_impl(tabx, taby, digits, c: int, s: int):
    """tabx/taby: [16, K] affine bases; digits: [B, K] int32, one row a
    commit; K = c*s.  The B commits share every step: their chunks sit
    side by side in K6's scan (B * c chunks), and each fold and scan adds
    their lanes in one call.  Every lane is the one a commit alone has, so
    each commit's result is the same raw limbs.  -> [B, 48]."""
    nb = digits.shape[0]
    order = torch.argsort(digits, dim=1, stable=True)
    d = torch.gather(digits, 1, order)
    dc = d.reshape(nb * c, s)  # commit b's chunks are rows b*c ... b*c + c - 1
    prev = torch.cat([dc[:, :1], dc[:, :-1]], dim=1)
    pts = torch.cat([tabx[:, order], taby[:, order]], dim=0)  # [32, B, K]
    pts = pts.reshape(2 * NLIMBS, nb * c, s).permute(2, 0, 1)  # [S, 32, B*C]
    prefix = run_scan(dc.T.contiguous(), prev.T.contiguous(), pts.contiguous())

    bvec = torch.arange(NB, dtype=digits.dtype, device=digits.device)
    idx = torch.searchsorted(dc, bvec.expand(nb * c, NB).contiguous(), right=True) - 1
    gidx = idx.clamp(min=0)
    valid = (idx >= 0) & (torch.gather(dc, 1, gidx) == bvec[None, :]) & (bvec[None, :] > 0)
    # bucket[b, l, ch] = prefix[gidx[ch, b], l, ch]
    buckets = torch.gather(
        prefix, 0, gidx.T[:, None, :].expand(NB, 3 * NLIMBS, nb * c)
    )  # [NB, 48, B*C]
    zpart = buckets[:, 2 * NLIMBS :, :] * valid.T[:, None, :].to(DTYPE)
    buckets = torch.cat([buckets[:, : 2 * NLIMBS, :], zpart], dim=1)
    buckets = buckets.permute(1, 0, 2).reshape(3 * NLIMBS, NB, nb, c)

    m = c
    while m > 1:
        half = m // 2
        a = buckets[..., :half].reshape(3 * NLIMBS, -1)
        b = buckets[..., half:m].reshape(3 * NLIMBS, -1)
        buckets = jadd_stacked(a, b).reshape(3 * NLIMBS, NB, nb, half)
        m = half
    buckets = buckets[:, 1:, :, 0].transpose(1, 2)  # [48, B, NB-1] (drop bucket 0)
    return _fold_stacked(_suffix_scan_stacked(buckets))[..., 0].T  # [B, 48]


def msm_fixed_affine(tabx, taby, digits):
    """MSM over pre-shifted affine window tables; digits [K] -> [48]
    Jacobian limbs, or [B, K] (B commits over the same tables, in one
    pipeline) -> [B, 48]."""
    k = digits.shape[-1]
    c = _choose_chunks(k)
    # Steps per chunk are rounded up to a multiple of 16 once above it, as
    # the JAX pipeline does for its 16-step kernel unroll (m = 544 gives
    # s = 17 there); the digit-0 pads never reach a bucket.
    s = -(-k // c)
    if s > _STEP_ALIGN:
        s = -(-s // _STEP_ALIGN) * _STEP_ALIGN
    padk = c * s - k
    rows = digits.reshape(-1, k)
    if padk:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], padk))], dim=1)
        tabx = torch.cat([tabx, tabx[:, :1].expand(NLIMBS, padk)], dim=1)
        taby = torch.cat([taby, taby[:, :1].expand(NLIMBS, padk)], dim=1)
    out = _msm_impl(tabx, taby, rows, c, s)
    return out[0] if digits.ndim == 1 else out


# ---------------------------------------------------------------------------
# Batched inversion + Jacobian -> affine (window-table construction).
# ---------------------------------------------------------------------------

def _shifted_fill_one(x, shift: int, forward: bool):
    one = fq.const("ONE_MONT", x.device, 2).expand(NLIMBS, shift)
    if forward:
        return torch.cat([one, x[:, :-shift]], dim=1)
    return torch.cat([x[:, shift:], one], dim=1)


def batch_inv_mont(field: str, a):
    """Batched inverse of nonzero [16, W] Montgomery elements.

    Log-depth Hillis-Steele prefix AND suffix products, one scalar
    inversion on the host, then inv_i = P_{i-1} * S_{i+1} * T^-1."""
    from .limbs import FIELDS

    ops = FIELDS[field]
    w = a.shape[-1]
    pre, suf = a, a
    shift = 1
    while shift < w:
        pre = ops.mul(pre, _shifted_fill_one(pre, shift, True))
        suf = ops.mul(suf, _shifted_fill_one(suf, shift, False))
        shift *= 2
    total = ops.from_mont_host(pre[:, -1])
    tinv = ops.scalar(pow(total, -1, ops.modulus), a.device)
    both = ops.mul(_shifted_fill_one(pre, 1, True), _shifted_fill_one(suf, 1, False))
    return ops.mul(both, tinv[:, None])


def jac_to_affine_batch(X, Y, Z):
    """Batched Jacobian -> affine (Z must be nonzero everywhere)."""
    zi = batch_inv_mont("fq", Z)
    zi2 = fq.mul(zi, zi)
    zi3 = fq.mul(zi2, zi)
    return fq.mul(X, zi2), fq.mul(Y, zi3)


def affine_from_jacobian(X, Y, Z):
    """Batched Jacobian -> affine on [16, *batch] coordinates."""
    shape = X.shape
    ax, ay = jac_to_affine_batch(*(c.reshape(NLIMBS, -1) for c in (X, Y, Z)))
    return ax.reshape(shape), ay.reshape(shape)


def build_affine_tables(x, y):
    """Affine bases [16, n] -> affine window tables [16, 32n].

    Window w holds 2^(8w) * P_i (window-major); the doubling ladder is K7,
    one launch per window."""
    cur = (x, y, fq.full("ONE_MONT", x))
    outs = []
    for w in range(NWINDOWS):
        outs.append(cur)
        if w < NWINDOWS - 1:
            cur = jac_double_n(cur, WINDOW_BITS)
    X, Y, Z = (torch.cat([o[i] for o in outs], dim=1) for i in range(3))
    return jac_to_affine_batch(X, Y, Z)
