"""Length-sharded proving: the four-step distributed NTT, the sharded
commit engine and rounds 2-5 of one proof across a mesh.

Counterpart of the JAX package's `parallel/sharded.py`, on
torch.distributed and SPMD (parallel/mesh.py): every rank runs these
functions with the same replicated inputs, takes its own shard of them by
its index along the mesh axis (the JAX `in_specs`), computes on its device,
and exchanges through `all_to_all` / `all_gather` where the JAX kernels do.
Where the JAX code returns a replicated natural-order view (`_nat`), the
ranks all-gather their blocks.  Every transform runs the port's own
kernels: the local NTTs' stages are K2 launches, every product a K1.

Four-step DFT over Fr: an order-N transform, N = R * C, of the row-major
[R, C] matrix x[j1 * C + j2] = mat[j1, j2], column-sharded (each rank holds
C / D columns): local column transforms of size R, the twiddle w^(k1 * j2),
one all_to_all that re-shards rows, local row transforms of size C.  The
output is row-sharded with out[k1, k2] = X[k1 + R * k2]: the "permuted"
layout.  A four-step's row-sharded output is the next one's column-sharded
input after a local transpose, so round 3 chains three transforms with one
all_to_all each and no gather.

The round bodies call the single-device prover's own algebra
(`_perm_grand_product`, `_quotient_impl`, `_linearization_impl`), so the
sharded proof's fields are the single-device proof's.  T reaches round 5 in
coefficient form (the port's rounds keep it so), so round 5 starts at the
coset lift: two all_to_alls, where the JAX package's round 5 takes three.
"""

from __future__ import annotations

import functools

import torch

from ..fields import Fr, FR_MOD
from ..ops import ntt as _ntt
from ..ops import msm2
from ..ops.curve import FixedBaseMSM, jac_fold_sum, jac_identity
from ..ops.limbs import fq, fr, NLIMBS, DTYPE
from ..ops.ntt_fourstep import _stockham_axis2, _twiddle_table
from ..prover import (
    LOOKUP_ROWS,
    _barycentric_finish,
    _coset_x_consts_impl,
    _linearization_impl,
    _perm_grand_product,
    _quotient_impl,
)
from .mesh import Mesh, all_gather, all_gather_object, all_to_all, gather_axis, ring_shift


def _factor(n: int, ndev: int):
    """n = n1*n2 with n1, n2, 4*n2 all divisible by ndev (n1 >= n2).

    Raises ValueError (not assert — `python -O` must not silently let an
    unshardable size into the sharded path).
    """
    n1 = 1 << ((n.bit_length() - 1 + 1) // 2)
    n2 = n // n1
    if n1 % ndev != 0 or n2 % ndev != 0:
        raise ValueError(f"group order {n} too small to shard {ndev} ways")
    return n1, n2


def _block(mesh: Mesh, axis: str, size: int) -> slice:
    """This rank's contiguous block of an axis of `size` sharded D ways."""
    w = size // mesh.shape[axis]
    i = mesh.index(axis)
    return slice(i * w, (i + 1) * w)


# ---------------------------------------------------------------------------
# Sharded MSM.
# ---------------------------------------------------------------------------

def sharded_msm(mesh: Mesh, axis: str, bases, digits):
    """MSM over bases / digits sharded along the mesh axis.

    bases: (X, Y, Z) Jacobian Montgomery limbs [16, K], the identity (Z =
    0) allowed; digits: int32 [K] 8-bit digits (replicated).  K must
    divide evenly by the axis size.  Each rank takes its contiguous block,
    gives its identity lanes Z = 1 and digit 0 (bucket 0 is dropped, so
    such a lane adds nothing), converts the block to affine and runs the
    msm2 pipeline on it; the D partial points are all-gathered and summed
    by `jac_fold_sum`.  Returns the replicated Jacobian point ([16]
    coordinates)."""
    k = digits.shape[-1]
    if k % mesh.shape[axis]:
        raise ValueError(f"{k} bases do not shard {mesh.shape[axis]} ways")
    cols = _block(mesh, axis, k)
    x, y, z = (c[:, cols] for c in bases)
    ident = fq.is_zero(z)
    z = torch.where(ident[None], fq.const("ONE_MONT", z.device, 2), z)
    x, y = msm2.jac_to_affine_batch(x, y, z)
    local = msm2.msm_fixed_affine(x, y, torch.where(ident, 0, digits[cols]))
    return _fold_partials(local, mesh, axis)


def _fold_partials(local, mesh: Mesh, axis: str):
    """Each rank's [48] Jacobian partial -> their replicated sum, [16]
    coordinates: one all_gather, then `jac_fold_sum`."""
    partials = all_gather(local, mesh, axis)  # [D, 48]
    return jac_fold_sum(tuple(partials[:, i * NLIMBS : (i + 1) * NLIMBS].T for i in range(3)))


class MeshMSM:
    """Mesh-sharded KZG commit engine over a `FixedBaseMSM`.

    The engine's first n points (n = engine.n unless given; the prover
    shards only its group order's) are cut into D contiguous blocks of
    ceil(n / D), the last shorter and any past n empty.  Each rank holds a
    FixedBaseMSM over its block on the engine's device, so the window
    tables are sharded as the JAX package shards its Jacobian tables.  A
    commit of m <= n coefficients pads them with zeros to n; each rank
    commits its slice through its engine (msm3 from 8192 coefficients a
    rank, msm2 below, msm3's overflow fallback included), and the D
    partial points are all-gathered and summed.  A commitment is linear
    in the points, so the sum is the single-device commit.  A rank whose
    slice is all zeros, or whose block is empty, still takes part (its
    partial is the identity).  If the engine has a `cache_path`, rank r of
    D caches its engine's tables under `{cache_path}.rank{r}of{D}`, so that
    ranks never write each other's files."""

    def __init__(self, engine: FixedBaseMSM, mesh: Mesh, axis: str, n: int | None = None):
        d = mesh.shape[axis]
        n = engine.n if n is None else n
        if n > engine.n:
            raise ValueError(f"{n} points asked of an engine of {engine.n}")
        self.n = n
        self.mesh, self.axis = mesh, axis
        width = -(-n // d)
        start = min(mesh.index(axis) * width, n)
        self._cols = slice(start, min(start + width, n))
        cache_path = engine.cache_path
        if cache_path is not None:
            cache_path = f"{cache_path}.rank{mesh.index(axis)}of{d}"
        self.engine = (engine.block(self._cols, cache_path, mesh.device)
                       if self._cols.stop > start else None)

    def _slices(self, coeff_list):
        """This rank's block of each zero-padded coefficient row."""
        width = self._cols.stop - self._cols.start
        parts = []
        for coeffs in coeff_list:
            if coeffs.shape[-1] > self.n:
                raise ValueError("polynomial degree exceeds the mesh engine's SRS")
            mine = coeffs[:, self._cols]
            if mine.shape[-1] < width:
                pad = torch.zeros((NLIMBS, width - mine.shape[-1]), dtype=DTYPE, device=coeffs.device)
                mine = torch.cat([mine, pad], dim=1)
            parts.append(mine)
        return parts

    def msm_mont(self, coeffs_mont):
        """Montgomery coefficients [16, m <= n] (replicated) -> the
        replicated Jacobian commit, a triple of [16] limbs on this rank's
        device: one all_gather of the D partials, then `jac_fold_sum`."""
        (mine,) = self._slices([coeffs_mont])
        if self.engine is None:
            local = torch.cat(jac_identity((), self.mesh.device))
        else:
            local = torch.cat(self.engine.msm_mont(mine))
        return _fold_partials(local, self.mesh, self.axis)

    def commit_batch(self, coeff_list):
        """Montgomery coefficient rows [16, m <= n] (replicated) -> host
        affine points, one all_gather for the whole list."""
        from ..ec import pt_add

        parts = self._slices(coeff_list)
        mine = self.engine.commit_batch(parts) if self.engine is not None else [None] * len(parts)
        partials = all_gather_object(mine, self.mesh, self.axis)
        out = []
        for i in range(len(coeff_list)):
            acc = None
            for rank_points in partials:
                acc = pt_add(acc, rank_points[i])
            out.append(acc)
        return out

    def commit_mont(self, coeffs_mont):
        return self.commit_batch([coeffs_mont])[0]


# ---------------------------------------------------------------------------
# Four-step distributed NTT.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _twiddle_matrix(rows: int, cols: int, inverse: bool, block: tuple, device) -> torch.Tensor:
    """Columns block[0]:block[1] of the [16, rows, cols] matrix w^(r * c)
    (Montgomery), w the order rows * cols root (its inverse for an inverse
    transform); built on the device (ntt_fourstep's doubling table) and
    cached per shape and block, as the JAX package caches its host-built
    matrices."""
    full = _twiddle_table(rows * cols, cols, rows, inverse, device)  # [16, rows, cols]
    return full[:, :, block[0] : block[1]].contiguous()


def _twiddles(mesh: Mesh, axis: str, rows: int, cols: int, inverse: bool) -> torch.Tensor:
    b = _block(mesh, axis, cols)
    return _twiddle_matrix(rows, cols, inverse, (b.start, b.stop), mesh.device)


def _four_step(x, rows: int, cols: int, inverse: bool, mesh: Mesh, axis: str):
    """Four-step DFT of the [rows, cols] matrix whose column block this
    rank holds, x [16, *batch, rows, cols / D] -> its row block of the
    permuted output [16, *batch, rows / D, cols], out[k1, k2] =
    X[k1 + rows * k2].  Inverse: the inverse DFT (the two passes' 1/rows
    and 1/cols compose to 1/N)."""
    y = _stockham_axis2(x, rows, inverse)  # column transforms, size rows
    tw = _twiddles(mesh, axis, rows, cols, inverse)
    y = fr.mul(y, tw.reshape((NLIMBS,) + (1,) * (y.ndim - 3) + tw.shape[1:]))
    y = all_to_all(y, y.ndim - 2, y.ndim - 1, mesh, axis)  # split rows, gather columns
    return _ntt.ntt(y, inverse)  # row transforms, size cols


def _nat(arr, total: int):
    """Permuted four-step output -> natural order: arr[..., r, c] holds
    index r + R * c; returns [..., total]."""
    return arr.transpose(-1, -2).reshape(arr.shape[:-2] + (total,))


def _gather_nat(local, total: int, mesh: Mesh, axis: str):
    """A permuted output's row blocks -> the replicated natural-order
    [..., total] view."""
    return _nat(gather_axis(local, local.ndim - 2, mesh, axis), total)


def sharded_ntt(mesh: Mesh, axis: str, mat, inverse: bool = False):
    """Distributed DFT over Fr via the four-step algorithm.

    mat: int32[16, n1, n2] Montgomery, replicated (each rank transforms its
    column block).  Returns the replicated [16, n1, n2] with
    out[:, k1, k2] = X[k1 + n1 * k2] (the ranks' row blocks gathered)."""
    _, n1, n2 = mat.shape
    ndev = mesh.shape[axis]
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"a [{n1}, {n2}] transform does not shard {ndev} ways")
    x = mat[:, :, _block(mesh, axis, n2)]
    return gather_axis(_four_step(x, n1, n2, inverse, mesh, axis), 1, mesh, axis)


def sharded_intt(mesh: Mesh, axis: str, values):
    """Lagrange stack [16, B, n] (replicated) -> natural monomial
    coefficients [16, B, n] (replicated), every butterfly stage
    length-sharded over the mesh (one all_to_all, one all_gather)."""
    nlimb, nbatch, n = values.shape
    n1, n2 = _factor(n, mesh.shape[axis])
    x = values.reshape(nlimb, nbatch, n1, n2)[..., _block(mesh, axis, n2)]
    return _gather_nat(_four_step(x, n1, n2, True, mesh, axis), n, mesh, axis)


# ---------------------------------------------------------------------------
# Sharded round 2: the grand product's prefix scan across the mesh.
# ---------------------------------------------------------------------------

def sharded_round2(mesh: Mesh, axis: str, wires_sigmas, beta, gamma):
    """Grand product Z across the mesh (reference prover.py:121-152 math).

    wires_sigmas: [16, 6, n] = (A, B, C, S1, S2, S3) Lagrange values and
    beta, gamma [16], replicated.  Each rank runs the single-device prefix
    product over its contiguous block of n / D rows; the D block totals
    (f / g over the block) are all-gathered, and rank r's carry is the
    product of the totals of ranks < r (one for rank 0).  The inclusive
    products shift right by one row: a block's first value is the last
    inclusive product of the block before (a ring shift; one for rank 0).
    Returns (Z [16, n] replicated, its closing value [16], which is one
    for a satisfied permutation)."""
    n = wires_sigmas.shape[-1]
    cols = _block(mesh, axis, n)
    rows = [wires_sigmas[:, i, cols] for i in range(6)]
    roots = _ntt._roots_impl(n, False, wires_sigmas.device)[:, cols]
    z_loc, total = _perm_grand_product(*rows, roots, beta, gamma)
    # Inclusive local products: z_loc is their right shift with z_loc[0] = 1.
    incl = torch.cat([z_loc[:, 1:], total[:, None]], dim=1)
    totals = all_gather(total, mesh, axis)  # [D, 16]
    one = fr.const("ONE_MONT", incl.device)
    carries = [one]
    for t in totals:
        carries.append(fr.mul(carries[-1], t))
    idx = mesh.index(axis)
    incl = fr.mul(incl, carries[idx][:, None])
    prev = ring_shift(incl[:, -1], mesh, axis)
    first = one if idx == 0 else prev
    z = torch.cat([first[:, None], incl[:, :-1]], dim=1)
    return gather_axis(z, 1, mesh, axis), carries[-1]


# ---------------------------------------------------------------------------
# Sharded round 3: coset extend -> quotient -> coefficients, one proof.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _perm_tables(n1: int, n2: int, block: tuple, device):
    """Rows block[0]:block[1] of the [16, 4 n2, n1] tables of the
    permuted 4n layout: position (k1', k2') holds the evaluation at index
    k' = k1' + 4 n2 k2', so q^k' and w4^k' (the quotient's X and Z_H
    constants) are laid out to match.  Built on the device, cached."""
    qroots, w4p = _coset_x_consts_impl(n1 * n2, device)  # [16, 4n] natural
    k1 = torch.arange(block[0], block[1], device=device)[:, None]
    k2 = torch.arange(n1, device=device)[None, :]
    kk = (k1 + 4 * n2 * k2).reshape(-1)
    shape = (NLIMBS, block[1] - block[0], n1)
    return qroots[:, kk].reshape(shape), w4p[:, kk].reshape(shape)


def _offset_powers(mesh: Mesh, axis: str, offset, n1: int, count2: int):
    """For the permuted layout k = k1 + n1 * k2: this rank's block of
    offset^k1 (k1 < n1) and all of (offset^n1)^k2 (k2 < count2), [16, *]
    Montgomery on the mesh's device."""
    off = int(offset)
    w1 = _ntt.scalar_powers(fr.scalar(off, mesh.device), n1)[:, _block(mesh, axis, n1)]
    w2 = _ntt.scalar_powers(fr.scalar(pow(off, n1, FR_MOD), mesh.device), count2)
    return w1, w2


def _coset_lift(coeffs_rows, w1, w2, mesh: Mesh, axis: str, n1: int, n2: int):
    """Coefficients in the permuted layout, this rank's k1 columns
    [16, P, n2 (k2), n1 / D (k1)] -> their values on the offset 4n coset,
    this rank's row block of the permuted [16, P, 4 n2 / D, n1]: scale by
    offset^k, zero-pad to 4 n2 rows, forward four-step of size 4n."""
    m = fr.mul(fr.mul(coeffs_rows, w2[:, None, :, None]), w1[:, None, None, :])
    pad = torch.zeros(m.shape[:2] + (3 * n2,) + m.shape[3:], dtype=DTYPE, device=m.device)
    return _four_step(torch.cat([m, pad], dim=2), 4 * n2, n1, False, mesh, axis)


def _coset_to_coeffs(values, offset, mesh: Mesh, axis: str, n1: int, n2: int):
    """Values on the offset 4n coset, this rank's row block of the
    permuted [16, *batch, 4 n2 / D, n1] -> its row block of the monomial
    coefficients in the permuted layout [16, *batch, n1 / D, 4 n2]: local
    transpose, inverse four-step, unscale by offset^-k."""
    v1, v2 = _offset_powers(mesh, axis, pow(int(offset), -1, FR_MOD), n1, 4 * n2)
    c = _four_step(values.transpose(-1, -2), n1, 4 * n2, True, mesh, axis)
    lead = (1,) * (c.ndim - 3)
    c = fr.mul(c, v1.reshape((NLIMBS,) + lead + (-1, 1)))
    return fr.mul(c, v2.reshape((NLIMBS,) + lead + (1, -1)))


class Round3Out:
    """Outputs of the sharded round 3.

    This rank's row blocks of the four-step-permuted arrays (`bigs_p`
    [16, P, 4 n2 / D, n1], `xvals_p`, `quot_p` [16, 4 n2 / D, n1], `qcoef_p`
    [16, n1 / D, 4 n2]), which the sharded round 5 consumes as they are,
    and their replicated natural-order views (bigs [16, P, 4n], xvals,
    quot, qcoeffs [16, 4n]).  Each view is an all_gather at first read, so
    every rank reads the same views in the same order."""

    def __init__(self, mesh: Mesh, axis: str, n: int, bigs_p, xvals_p, quot_p, qcoef_p):
        self._mesh, self._axis, self._n = mesh, axis, n
        self.bigs_p, self.xvals_p, self.quot_p, self.qcoef_p = bigs_p, xvals_p, quot_p, qcoef_p

    def _view(self, local):
        return _gather_nat(local, 4 * self._n, self._mesh, self._axis)

    @functools.cached_property
    def bigs(self):
        return self._view(self.bigs_p)

    @functools.cached_property
    def xvals(self):
        return self._view(self.xvals_p)

    @functools.cached_property
    def quot(self):
        return self._view(self.quot_p)

    @functools.cached_property
    def qcoeffs(self):
        return self._view(self.qcoef_p)


def sharded_round3(
    mesh: Mesh, axis: str, polys, beta, gamma, alpha, offset,
    custom: bool = False, lookup_scalars=None,
) -> Round3Out:
    """Round 3 of one proof with every NTT length-sharded over the mesh.

    polys: int32[16, P, n] Lagrange stack (a, b, c, pi, ql, qr, qm, qo,
    qc, z, zshift, s1, s2, s3, l0, then QCUBE when `custom`, then
    LOOKUP_ROWS), replicated; offset: host Fr (the coset offset);
    beta / gamma / alpha: [16] Montgomery limbs; lookup_scalars: (delta,
    epsilon, t_last) [16] limbs with lookups, else None.

    Chain (three all_to_alls, no gather):
      column-sharded inverse four-step (n = n1 x n2)
      -> scale by offset^k (sharded powers)
      -> local transpose + zero-pad             # [4 n2, n1] column-sharded
      -> forward four-step (size 4n)
      -> elementwise quotient in the permuted layout (constants permuted)
      -> local transpose
      -> inverse four-step (size 4n) + offset^-k unscale
    """
    _, npoly, n = polys.shape
    n1, n2 = _factor(n, mesh.shape[axis])
    x = polys.reshape(NLIMBS, npoly, n1, n2)[..., _block(mesh, axis, n2)]
    c = _four_step(x, n1, n2, True, mesh, axis)  # [16, P, n1/D, n2] coefficients
    w1, w2 = _offset_powers(mesh, axis, offset, n1, n2)
    bigs = _coset_lift(c.transpose(2, 3), w1, w2, mesh, axis, n1, n2)  # [16, P, 4n2/D, n1]

    rblock = _block(mesh, axis, 4 * n2)
    qperm, wperm = _perm_tables(n1, n2, (rblock.start, rblock.stop), mesh.device)
    local = bigs.shape[2] * n1
    flat = [bigs[:, i].reshape(NLIMBS, local) for i in range(npoly)]
    off = int(offset)
    one = fr.const("ONE_MONT", mesh.device, 2)
    xv = fr.mul(fr.scalar(off, mesh.device)[:, None], qperm.reshape(NLIMBS, local))
    zh = fr.sub(fr.mul(fr.scalar(pow(off, n, FR_MOD), mesh.device)[:, None],
                       wperm.reshape(NLIMBS, local)), one)
    lookup = None
    if lookup_scalars is not None:
        base = 16 if custom else 15
        lookup = {name: flat[base + i] for i, name in enumerate(LOOKUP_ROWS)}
        delta, epsilon, tlast = lookup_scalars
        lookup.update(delta=delta, epsilon=epsilon, tlast=tlast,
                      gl=fr.scalar(Fr.root_of_unity(n) ** (n - 1), mesh.device))
    quot = _quotient_impl(
        *flat[:15], xv, fr.batch_inv(zh), beta, gamma, alpha,
        qcube=flat[15] if custom else None, lookup=lookup,
    )
    shape = (NLIMBS, bigs.shape[2], n1)
    quot_p = quot.reshape(shape)
    qcoef_p = _coset_to_coeffs(quot_p, offset, mesh, axis, n1, n2)
    return Round3Out(mesh, axis, n, bigs, xv.reshape(shape), quot_p, qcoef_p)


# ---------------------------------------------------------------------------
# Sharded round 4: barycentric openings, local partial sums.
# ---------------------------------------------------------------------------

def sharded_round4(mesh: Mesh, axis: str, values, xs):
    """Barycentric openings across the mesh: values [16, B, n] and points
    xs [16, B] (replicated) -> evaluations [16, B].

    Each rank sums the terms of its block of n / D domain points; the D
    partial sums are all-gathered and summed; the finish (the (x^n - 1) / n
    scale) is the single-device `_barycentric_batch`'s."""
    n = values.shape[-1]
    cols = _block(mesh, axis, n)
    roots = _ntt._roots_impl(n, False, values.device)[:, cols]
    denom = fr.sub(xs[:, :, None], roots[:, None, :])
    terms = fr.mul(fr.mul(values[..., cols], roots[:, None, :]), fr.batch_inv(denom))
    partials = all_gather(_ntt._treesum(terms), mesh, axis)  # [D, 16, B]
    return _barycentric_finish(_ntt._treesum(partials.permute(1, 2, 0)), xs, n)


# ---------------------------------------------------------------------------
# Sharded round 5: T's coset lift, the linearization and the opening
# quotients, in the permuted layout of the sharded round 3.
# ---------------------------------------------------------------------------

def sharded_round5(
    mesh: Mesh, axis: str, r3: Round3Out, t_coeffs, scalars, offset,
    custom: bool = False, cube_ev=None, lookup_scalars=None,
):
    """Round 5 with T's coset extension, the linearization and the two
    opening quotients length-sharded (reference prover.py:241-306 math).

    r3: the sharded round 3's output (its permuted blocks are used as they
    are).  t_coeffs: [16, 3, n] monomial coefficients of T1, T2, T3,
    replicated.  scalars: the 17 [16] limbs a_ev, b_ev, c_ev, s1_ev, s2_ev,
    zw_ev, pi_ev, l0_ev, zh_ev, zeta^n, zeta^2n, beta, gamma, alpha, zeta,
    zeta * w, v (`_linearization_impl`'s order); cube_ev with `custom`;
    lookup_scalars: the dict of `_linearization_impl`'s lookup scalars
    (c_z2, c_h1, c_qk, c_const and the eight openings) with lookups.
    Returns (R [16, 4n] natural, W_z and W_zw coefficients [16, 2, 4n]),
    replicated."""
    n = t_coeffs.shape[-1]
    n1, n2 = _factor(n, mesh.shape[axis])
    # Coefficient k = k1 + n1 * k2 sits at [k2, k1]: this rank's k1 columns.
    tm = t_coeffs.reshape(NLIMBS, 3, n2, n1)[..., _block(mesh, axis, n1)]
    w1, w2 = _offset_powers(mesh, axis, offset, n1, n2)
    t_big = _coset_lift(tm, w1, w2, mesh, axis, n1, n2)  # [16, 3, 4n2/D, n1]

    rows = t_big.shape[2]
    local = rows * n1
    flats = [r3.bigs_p[:, i].reshape(NLIMBS, local) for i in range(r3.bigs_p.shape[1])]
    t1, t2, t3 = (t_big[:, i].reshape(NLIMBS, local) for i in range(3))
    lookup = None
    if lookup_scalars is not None:
        base = 16 if custom else 15
        lookup = {name: flats[base + i] for i, name in enumerate(LOOKUP_ROWS)
                  if name in ("f", "t", "h1", "h2", "z2", "qk")}
        lookup.update(lookup_scalars)
    r_big, w_z, w_zw = _linearization_impl(
        flats[:15], t1, t2, t3, r3.xvals_p.reshape(NLIMBS, local), *scalars,
        qcube=flats[15] if custom else None, cube_ev=cube_ev, lookup=lookup,
    )
    ws = torch.stack([w_z, w_zw], dim=1).reshape(NLIMBS, 2, rows, n1)
    wc = _coset_to_coeffs(ws, offset, mesh, axis, n1, n2)  # [16, 2, n1/D, 4n2]
    r_big = _gather_nat(r_big.reshape(NLIMBS, rows, n1), 4 * n, mesh, axis)
    return r_big, _gather_nat(wc, 4 * n, mesh, axis)


def host_matrix_to_vector(mat) -> list[int]:
    """Gathered four-step output [16, n1, n2] -> the X[k] vector of ints."""
    return fr.from_mont_host_many(mat.transpose(1, 2))


def vector_to_host_matrix(vec: list[int], n1: int, n2: int) -> torch.Tensor:
    """x[j] -> [16, n1, n2] row-major matrix (j = j1 * n2 + j2) in
    Montgomery form, on the host."""
    from ..ops.limbs import to_device

    return to_device(fr.to_mont_host_many(vec), "cpu").reshape(NLIMBS, n1, n2)
