"""Fixed-base Pippenger MSM v3 — signed 16-bit windows, packed wide
incomplete-add run-scan, sparse run-end extraction.

Counterpart of the JAX package's `ops/msm3.py`: the commit path for
m >= 8192 (`ops/curve.py` routes to it).  Its kernels (CUDA C++):

* K3 `madd_packed` — incomplete Jacobian += affine on packed rows
  (`csrc/msm3.cu`);
* K4 `jadd_packed` — incomplete Jacobian += Jacobian on packed rows, the
  merge scan (`csrc/msm3.cu`), and `_dense_buckets`, all J rounds of the
  dense-bucket stage in one launch of the same add (`k4_dense_buckets`);
* K5 `suffix_fold` — the whole Blelloch bucket fold in one launch
  (`csrc/msm.cu` `k5_suffix_fold`, the complete add of `msm2.jadd_stacked`).

The table build is K7.

Pipeline for sum_i c_i * P_i:

1. **Signed 16-bit windows**: 16 windows, one per 16-bit limb, with digits
   recoded into [-2^15, 2^15]; the bucket id is |digit| and the base point
   is negated inside K3 when the digit is negative.  16m insertions instead
   of msm2's 32m.
2. **Packed point layout**: a table point is 16 words of 32 bits, two
   16-bit limbs each (low limb in the low half), i.e. the 8-word elements
   the CUDA kernels compute on, so K3 and K4 load and store packed rows
   with no repacking.  Words are stored as int32 like every limb tensor; a
   word >= 2^31 is negative there, so `unpack_array` masks after its
   arithmetic shift.  Run prefixes, the scan carry and the merge stage stay
   packed.
3. **Step-major order via index permutation**: the sorted index vector is
   permuted, so one gather lands the points in the scan's step-major order.
4. **Wide scan with an incomplete mixed add**: S chained steps of width
   C = K/S (up to 2^17 lanes), an 11-product *incomplete* Jacobian+affine
   add with no infinity or doubling branches.  Safe because every in-run
   partial sum is a subset sum of distinct SRS multiples: a collision
   (H = 0) or an identity would be a discrete-log relation on the fixed
   trusted SRS.  Run starts reset the accumulator to the incoming point
   through mask bit 0.  Padding and zero coefficients have key 0 and may
   add the same base to itself with H = 0; those lanes hold garbage that
   is never read, because `_extract_sorted` drops every run whose key is 0.
   K3 and K4 must therefore stay incomplete-but-branch-free, not complete.
5. **Sparse run-end extraction**: run ends (at most NBUCKET + C of them) are
   compacted by a second key sort, merged once more by a short Jacobian
   run-scan (K4), then gathered into a dense [24, 2^15] bucket array by a
   bounded-multiplicity searchsorted gather (`_J` rounds of K4).  The
   reduction sum_b b * B_b is a work-efficient Blelloch suffix scan (K5).
   The stage reports the largest bucket multiplicity it met; above `_J` the
   result is incomplete and the caller recommits through msm2.

Differences from the JAX module, none in the function computed: it keeps
one table layout (packed, window-major [16, 16n]) and the plain gather +
`_run_scan` route — the JAX module's row-layout table and fused gather scan
are a workaround for its device's gather unit; `_plan` does not floor C
at that device's kernel tile, so small problems get narrower scans; on the
card the dense stage's J gather rounds are one K4 launch in which each
thread loads its own bucket's entries, and the Blelloch fold is one K5
launch that runs the same levels pair for pair (the JAX module launches
per round and per level).  The Jacobian triple depends on the plan; the
affine point, which is what results are compared as, does not.
"""

from __future__ import annotations

import torch

from .limbs import fq, fq_plain, NLIMBS, DTYPE, LIMB_MASK, LIMB_BITS
from .cuda_lib import fn, check, stream_ptr, count_launch
from .cuda_mont import check_limbs, field_consts, jac_double_n, unstack_points
from .msm2 import jadd_stacked_plain, _fold_stacked, _identity_stacked, jac_to_affine_batch

WBITS = 16
NW = 16                      # 256 / 16 windows == one per 16-bit limb
NBUCKET = (1 << 15) + 1      # |signed digit| in [0, 2^15]
_BIG = 1 << 20               # dead-entry key sentinel (> any bucket id)
PACKED_PT = 2 * NLIMBS // 2    # 16 packed rows per affine point
PACKED_JAC = 3 * NLIMBS // 2   # 24 packed rows per Jacobian point


# ---------------------------------------------------------------------------
# Limb packing (2 x 16-bit limbs per 32-bit word).
# ---------------------------------------------------------------------------

def pack_array(a):
    """[2k, *] int32 16-bit limb rows -> [k, *] packed words.

    The high limb is sign-extended from 16 bits before it moves up, so the
    int32 result holds the same 32 bits as the unsigned word."""
    hi = (a[1::2] ^ 0x8000) - 0x8000
    return a[0::2] + hi * (1 << LIMB_BITS)


def unpack_array(p):
    """Inverse of `pack_array`: [k, *] packed -> [2k, *] limb rows."""
    lo = p & LIMB_MASK
    hi = (p >> LIMB_BITS) & LIMB_MASK
    return torch.stack([lo, hi], dim=1).reshape((2 * p.shape[0],) + p.shape[1:])


# ---------------------------------------------------------------------------
# K3 / K4: packed incomplete adds (mask bit 0: fresh restart; bit 1: negate
# q.y, K3 only; bit 2: dead lane keeps its accumulator, K4 only).
# ---------------------------------------------------------------------------

def _kern_madd_inc(k, p, q_aff, fresh):
    """Jacobian += affine, 11 products; fresh lanes restart at (x2, y2, 1).

    Incomplete: assumes p is non-identity and p != +-q on live lanes (see
    the module docstring for why that holds for in-run partial sums)."""
    X1, Y1, Z1 = p
    X2, Y2 = q_aff
    Z1Z1 = k.sqr(Z1)
    U2 = k.mul(X2, Z1Z1)
    S2 = k.mul(Y2, k.mul(Z1, Z1Z1))
    H = k.sub(U2, X1)
    R = k.sub(S2, Y1)
    HH = k.sqr(H)
    HHH = k.mul(H, HH)
    V = k.mul(X1, HH)
    X3 = k.sub(k.sub(k.sqr(R), HHH), k.add(V, V))
    Y3 = k.sub(k.mul(R, k.sub(V, X3)), k.mul(Y1, HHH))
    Z3 = k.mul(Z1, H)
    one = k.full("ONE_MONT", Z3)
    return k.select(fresh, X2, X3), k.select(fresh, Y2, Y3), k.select(fresh, one, Z3)


def _kern_jadd_inc(k, p, q, fresh):
    """Jacobian += Jacobian, 16 products (4 of them squarings); fresh lanes
    restart at q."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = k.sqr(Z1)
    Z2Z2 = k.sqr(Z2)
    U1 = k.mul(X1, Z2Z2)
    U2 = k.mul(X2, Z1Z1)
    S1 = k.mul(Y1, k.mul(Z2, Z2Z2))
    S2 = k.mul(Y2, k.mul(Z1, Z1Z1))
    H = k.sub(U2, U1)
    R = k.sub(S2, S1)
    HH = k.sqr(H)
    HHH = k.mul(H, HH)
    V = k.mul(U1, HH)
    X3 = k.sub(k.sub(k.sqr(R), HHH), k.add(V, V))
    Y3 = k.sub(k.mul(R, k.sub(V, X3)), k.mul(S1, HHH))
    Z3 = k.mul(k.mul(Z1, Z2), H)
    return k.select(fresh, X2, X3), k.select(fresh, Y2, Y3), k.select(fresh, Z2, Z3)


def _coords(packed):
    """Packed rows [8k, W] -> k coordinates of [16, W] limbs."""
    return unstack_points(unpack_array(packed), packed.shape[1:])


def madd_packed_plain(acc, q, mask):
    """One K3 step: packed acc [24, W], packed affine q [16, W], mask int32
    [W] -> packed [24, W]."""
    k = fq_plain
    x2, y2 = _coords(q)
    fresh = (mask & 1) != 0
    neg = (mask & 2) != 0
    # -y = 2p - y (lazy domain); affine y is never 0 on prime-order G1.
    y2 = k.select(neg, k.sub(torch.zeros_like(y2), y2), y2)
    out = _kern_madd_inc(k, _coords(acc), (x2, y2), fresh)
    return pack_array(torch.cat(out, dim=0))


def jadd_packed_plain(acc, q, mask):
    """One K4 step: packed acc [24, W], packed Jacobian q [24, W], mask int32
    [W] -> packed [24, W]."""
    k = fq_plain
    pa = _coords(acc)
    fresh = (mask & 1) != 0
    dead = (mask & 4) != 0
    out = _kern_jadd_inc(k, pa, _coords(q), fresh)
    out = tuple(k.select(dead, a, o) for a, o in zip(pa, out))
    return pack_array(torch.cat(out, dim=0))


_INC = {
    "madd": ("K3", "k3_madd_packed", PACKED_PT, madd_packed_plain),
    "jadd": ("K4", "k4_jadd_packed", PACKED_JAC, jadd_packed_plain),
}


def _inc_scan(which: str, acc, pts_sm, mask_sm):
    """S chained packed incomplete adds; every prefix is kept.

    acc [24, W] packed start; pts_sm [S, rows, W] step-major packed points
    (madd: 16 rows affine; jadd: 24 rows Jacobian); mask_sm [S, W] int32.
    Returns [S, 24, W].  On CUDA tensors one launch loops the S steps with
    the accumulator in registers; on CPU tensors the plain step is applied
    S times."""
    kernel, entry, rows, plain = _INC[which]
    steps, w = mask_sm.shape
    if acc.shape != (PACKED_JAC, w) or pts_sm.shape != (steps, rows, w):
        raise ValueError(
            f"{entry}: expected acc [24, W], points [S, {rows}, W], mask [S, W]; got "
            f"{tuple(acc.shape)}, {tuple(pts_sm.shape)}, {tuple(mask_sm.shape)}"
        )
    if not (acc.dtype == pts_sm.dtype == mask_sm.dtype == DTYPE):
        raise ValueError(f"{entry}: operands must be int32")
    if not (acc.is_cuda or pts_sm.is_cuda or mask_sm.is_cuda):
        outs = []
        for s in range(steps):
            acc = plain(acc, pts_sm[s], mask_sm[s])
            outs.append(acc)
        return torch.stack(outs)
    if not (acc.is_cuda and acc.device == pts_sm.device == mask_sm.device):
        raise ValueError(f"{entry}: operands must all be on one CUDA device")
    acc, pts_sm, mask_sm = acc.contiguous(), pts_sm.contiguous(), mask_sm.contiguous()
    out = torch.empty((steps, PACKED_JAC, w), dtype=DTYPE, device=acc.device)
    rc = fn(entry)(
        acc.data_ptr(), pts_sm.data_ptr(), mask_sm.data_ptr(), out.data_ptr(),
        steps, w, field_consts("fq"), stream_ptr(acc.device),
    )
    count_launch(kernel)
    check(rc, entry)
    return out


def madd_packed(acc, q, mask):
    """K3, one step: incomplete packed Jacobian += affine (see
    `madd_packed_plain`)."""
    return _inc_scan("madd", acc, q[None], mask.reshape(1, -1))[0]


def jadd_packed(acc, q, mask):
    """K4, one step: incomplete packed Jacobian += Jacobian (see
    `jadd_packed_plain`)."""
    return _inc_scan("jadd", acc, q[None], mask.reshape(1, -1))[0]


# ---------------------------------------------------------------------------
# Signed-digit recoding (digit w == 16-bit limb w, recoded to [-2^15, 2^15]).
# ---------------------------------------------------------------------------

def signed_digits16(raw, n_table: int):
    """Canonical limbs [16, m] -> (keys [16m] int32, payload [16m] int32).

    keys are bucket ids |digit|; payload packs (table index << 1) | sign
    where table index = w * n_table + i points into the window-major packed
    tables.  Window-major flattening.
    """
    m = raw.shape[1]
    keys = []
    signs = []
    carry = torch.zeros((m,), dtype=DTYPE, device=raw.device)
    for w in range(NW):
        e = raw[w] + carry  # <= 2^16
        big = e > (1 << 15)
        keys.append(torch.where(big, (1 << 16) - e, e))
        signs.append(big)
        carry = big.to(DTYPE)
    # BN254 scalars < 2^254 keep the top limb below 2^14: the final carry
    # cannot escape window 15.
    key = torch.stack(keys).reshape(-1)
    sign = torch.stack(signs).reshape(-1)
    idx = (
        torch.arange(NW, dtype=DTYPE, device=raw.device)[:, None] * n_table
        + torch.arange(m, dtype=DTYPE, device=raw.device)[None, :]
    ).reshape(-1)
    payload = (idx << 1) | sign.to(DTYPE)
    return key, payload


def build_affine_tables16(x, y):
    """Affine SRS bases [16, n] -> PACKED affine tables [16, 16n].

    Window w (holding 2^(16w) * P_i, 16 doublings apart: one K7 launch)
    lands at columns [w*n, (w+1)*n); row r packs limbs (2r, 2r+1) of x||y."""
    cur = (x, y, fq.full("ONE_MONT", x))
    outs = []
    for w in range(NW):
        outs.append(cur)
        if w < NW - 1:
            cur = jac_double_n(cur, WBITS)
    X, Y, Z = (torch.cat([o[i] for o in outs], dim=1) for i in range(3))
    ax, ay = jac_to_affine_batch(X, Y, Z)
    return pack_array(torch.cat([fq.canon(ax), fq.canon(ay)], dim=0))


# ---------------------------------------------------------------------------
# Wide run-scan (sorted keys -> per-run prefix emissions).
# ---------------------------------------------------------------------------

def _run_scan(pts_sm, mask_sm, which):
    """pts_sm: [S, rows, C] step-major packed points; mask_sm: [S, C] int32.
    Returns ys [S, 24, C] packed prefixes.  The start accumulator is all
    zeros: step 0 is fresh on every lane."""
    init = torch.zeros((PACKED_JAC, mask_sm.shape[1]), dtype=DTYPE, device=pts_sm.device)
    return _inc_scan(which, init, pts_sm, mask_sm)


def _extract_sorted(ys, ksm, S, C, T):
    """Compact the valid run ends of a scan, sorted by key.

    ys: [S, 24, C] packed prefixes; ksm: [S, C] step-major keys.  Returns
    (keys [T] ascending with _BIG tail, packed pts [24, T])."""
    ends = torch.cat(
        [ksm[1:] != ksm[:-1], torch.ones((1, C), dtype=torch.bool, device=ksm.device)]
    )
    valid = ends & (ksm > 0) & (ksm < _BIG)
    ekey = torch.where(valid, ksm, _BIG).reshape(-1)  # flat (s, c) order
    sk, sp = torch.sort(ekey, stable=True)
    sk = sk[:T]
    se = sp[:T] // C
    ce = sp[:T] % C
    pts = ys[se, :, ce].T  # [24, T]
    return sk, pts


def _step_major(flat, S, C):
    """[S*C]-flat chunk-major (chunk c = positions [cS, (c+1)S)) ->
    step-major [S, C]: out[s, c] = flat[c*S + s]."""
    return flat.reshape(C, S).T


def _step_major_pts(p, S, C):
    """[24, S*C] chunk-major points -> [S, 24, C] step-major."""
    return p.reshape(PACKED_JAC, C, S).permute(2, 0, 1)


def _fresh_mask(ksm):
    """[S, C] step-major keys -> bool [S, C]: a run starts here."""
    first = torch.ones((1, ksm.shape[1]), dtype=torch.bool, device=ksm.device)
    return torch.cat([first, ksm[1:] != ksm[:-1]])


# ---------------------------------------------------------------------------
# Dense bucket reduction (bounded-multiplicity gather + Blelloch suffix).
# ---------------------------------------------------------------------------

_J = 8  # max entries per bucket the dense gather folds (checked; fallback)

_NB2 = 1 << 15  # dense bucket array covers b in [1, 2^15]


def _dense_buckets_plain(keys, pts_packed, J: int, nb: int = _NB2):
    """keys [T] ascending (<= nb real, _BIG tail), pts_packed [24, T] ->
    (dense [48, nb] unpacked bucket sums for b = 1..nb, max multiplicity).

    J gather rounds, each added by the plain K4 step.  Incomplete is safe:
    every accumulator is a distinct-subset sum of SRS multiples (see the
    module docstring); a lane whose bucket has no j-th entry is dead (mask
    bit 2) and keeps its value, so empty buckets keep the initial Z = 0."""
    T = keys.shape[0]
    bvec = torch.arange(1, nb + 1, dtype=keys.dtype, device=keys.device)
    start = torch.searchsorted(keys, bvec)
    stop = torch.searchsorted(keys, bvec + 1)
    maxmult = (stop - start).max()
    acc = pack_array(_identity_stacked(nb, keys.device))
    for j in range(J):
        idx = start + j
        ok = (idx < stop) & (idx < T)
        gi = idx.clamp(max=T - 1)
        q = pts_packed[:, gi]  # [24, nb] packed gather
        mask = torch.where(ok, 1 if j == 0 else 0, 4).to(DTYPE)
        acc = jadd_packed_plain(acc, q, mask)
    return unpack_array(acc), maxmult


def _dense_buckets(keys, pts_packed, J: int, nb: int = _NB2):
    """K4's dense-bucket stage (see `_dense_buckets_plain`): on CUDA tensors
    one launch runs all J rounds, each thread finding its bucket's entries
    by binary search; the max multiplicity comes back as an int32 0-dim
    tensor.  On CPU tensors the plain rounds."""
    if not (keys.is_cuda or pts_packed.is_cuda):
        return _dense_buckets_plain(keys, pts_packed, J, nb)
    T = keys.shape[0]
    if pts_packed.shape != (PACKED_JAC, T) or keys.ndim != 1:
        raise ValueError(f"k4_dense_buckets: expected keys [T], points [24, T]; got "
                         f"{tuple(keys.shape)}, {tuple(pts_packed.shape)}")
    if not (keys.dtype == pts_packed.dtype == DTYPE):
        raise ValueError("k4_dense_buckets: operands must be int32")
    if not (keys.is_cuda and keys.device == pts_packed.device):
        raise ValueError("k4_dense_buckets: operands must be on one CUDA device")
    keys, pts_packed = keys.contiguous(), pts_packed.contiguous()
    dense = torch.empty((3 * NLIMBS, nb), dtype=DTYPE, device=keys.device)
    maxmult = torch.zeros((1,), dtype=DTYPE, device=keys.device)
    rc = fn("k4_dense_buckets")(
        keys.data_ptr(), pts_packed.data_ptr(), dense.data_ptr(), maxmult.data_ptr(),
        T, nb, J, field_consts("fq"), stream_ptr(keys.device),
    )
    count_launch("K4")
    check(rc, "k4_dense_buckets")
    return dense, maxmult[0]


def _blelloch_suffix_fold(dense):
    """sum_{b=1..W} b * B_b for dense [48, W] (index i holds b=i+1), W a
    power of two: the plain version of `suffix_fold`.

    Inclusive suffix sums S_t = sum_{b>=t} B_b via a work-efficient Blelloch
    scan (~2*W complete adds), then sum_b b*B_b = sum_t S_t by a fold."""
    add = jadd_stacked_plain
    a = torch.flip(dense, dims=[1])  # prefix scan on reversed = suffix scan
    levels = []
    cur = a
    while cur.shape[1] > 1:
        levels.append(cur)
        cur = add(cur[:, 0::2], cur[:, 1::2])
    ex = _identity_stacked(1, dense.device)
    for lev in reversed(levels):
        w = lev.shape[1]
        right = add(ex, lev[:, 0::2])
        ex = torch.stack([ex, right], dim=2).reshape(3 * NLIMBS, w)
    inc = add(ex, a)  # inclusive prefix of reversed = suffix
    return _fold_stacked(torch.flip(inc, dims=[1]), add)[:, 0]


def suffix_fold(dense):
    """K5's msm3 suffix fold: sum_b b * B_b as [48] Jacobian limbs for dense
    [48, W], W a power of two >= 2.  On CUDA tensors one cooperative launch
    runs the whole Blelloch schedule of `_blelloch_suffix_fold`, pair for
    pair, through a [2, 48, W] scratch buffer; on CPU tensors the plain
    version."""
    w = dense.shape[-1]
    if dense.ndim != 2 or dense.shape[0] != 3 * NLIMBS or w < 2 or w & (w - 1):
        raise ValueError(f"suffix_fold: expected [48, W] with W a power of two >= 2, "
                         f"got {tuple(dense.shape)}")
    if not dense.is_cuda:
        return _blelloch_suffix_fold(dense)
    (dense,) = check_limbs(3 * NLIMBS, dense)
    scratch = torch.empty((2, 3 * NLIMBS, w), dtype=DTYPE, device=dense.device)
    out = torch.empty((3 * NLIMBS,), dtype=DTYPE, device=dense.device)
    rc = fn("k5_suffix_fold")(
        dense.data_ptr(), scratch.data_ptr(), out.data_ptr(), w,
        field_consts("fq"), stream_ptr(dense.device),
    )
    count_launch("K5")
    check(rc, "k5_suffix_fold")
    return out


# ---------------------------------------------------------------------------
# Full pipeline.
# ---------------------------------------------------------------------------

def _plan(k: int):
    """Choose (S, C, padded K): C a power of two near k/32, at most 2^17."""
    c = max(1, min(1 << 17, k // 32))
    c = 1 << (c.bit_length() - 1)  # pow2 <= c
    s = -(-k // c)
    return s, c, s * c


def _pow2_at_least(v):
    return 1 << (v - 1).bit_length()


_S2 = 16  # steps of the merge scan


def plan_params(k: int):
    """Full pipeline plan for a K-insertion problem: (S, C, kpad, T, T2).

    T bounds the run ends of the scan (at most one per bucket plus one per
    chunk), T2 those of the merge scan over T/16 chunks; both are cut to
    the problem size.  k is 16 insertions per coefficient, which keeps the
    padded size, and so T, a multiple of the merge scan's 16 steps."""
    if k <= 0 or k % NW:
        raise ValueError(f"msm3 plans 16 insertions per coefficient, got k = {k}")
    S, C, kpad = _plan(k)
    T = min(_pow2_at_least(NBUCKET + C + 1), kpad)
    T2 = min(_pow2_at_least(NBUCKET + T // _S2 + 1), T)
    return S, C, kpad, T, T2


def _msm16_impl(tabp, key, payload, S, C, T, T2, J):
    skey, order = torch.sort(key, stable=True)
    spay = payload[order]
    # Step-major permutation of the small arrays; the single packed gather
    # then produces the scan's layout directly.
    ksm = _step_major(skey, S, C)
    psm = _step_major(spay, S, C)
    sidx = psm >> 1
    mask_sm = _fresh_mask(ksm).to(DTYPE) | ((psm & 1) << 1)
    pts_sm = tabp[:, sidx.reshape(-1)].reshape(PACKED_PT, S, C).permute(1, 0, 2)
    ys = _run_scan(pts_sm, mask_sm, "madd")
    k2, p2 = _extract_sorted(ys, ksm, S, C, T)

    # One merge round: scan the (sorted) run partials so each bucket's
    # entries collapse to at most a few, then extract again.
    C2 = T // _S2
    k2sm = _step_major(k2, _S2, C2)
    p2sm = _step_major_pts(p2, _S2, C2)
    ys2 = _run_scan(p2sm, _fresh_mask(k2sm).to(DTYPE), "jadd")
    k3, p3 = _extract_sorted(ys2, k2sm, _S2, C2, T2)

    dense, maxmult = _dense_buckets(k3.clamp(max=_BIG), p3, J)
    return suffix_fold(dense), maxmult


def msm_fixed_affine16(tabp, key, payload):
    """MSM over packed 16-bit-window affine tables.

    tabp: [16, 16n] packed window-major; key/payload from `signed_digits16`.
    Returns ([48] Jacobian limbs, max bucket multiplicity at the dense
    stage, a 0-dim tensor on the device) — the caller must fall back to a
    complete path if it exceeds `_J` (astronomically unlikely for
    non-adversarial scalar distributions, and merely yields an invalid
    proof, never a soundness problem)."""
    k = key.shape[0]
    S, C, kpad, T, T2 = plan_params(k)
    if kpad != k:
        key = torch.cat([key, key.new_zeros(kpad - k)])
        payload = torch.cat([payload, payload.new_zeros(kpad - k)])
    return _msm16_impl(tabp, key, payload, S, C, T, T2, _J)
