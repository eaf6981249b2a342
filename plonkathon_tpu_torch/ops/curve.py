"""G1 point arithmetic, the fixed-base MSM engine and its table cache.

Counterpart of the JAX package's `ops/curve.py`.  A commit of m >= 8192
coefficients goes through the signed 16-bit-window pipeline (`ops/msm3.py`)
and falls through to the 8-bit pipeline (`ops/msm2.py`) if msm3 reports a
bucket multiplicity above what its dense stage folds; smaller commits take
msm2 directly.  The route depends on m alone, not on the device.

Points are structure-of-arrays Jacobian coordinates over Fq limb tensors
(int32[16, *batch], Montgomery form); the identity is Z == 0.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import re
import tempfile

import numpy as np
import torch

from ..fields import FQ_MOD
from .limbs import fq, fr, NLIMBS, DTYPE, to_device
from .cuda_mont import jac_add, jac_double_n, unstack_points
from . import msm2, msm3

WINDOW_BITS = msm2.WINDOW_BITS
NWINDOWS = msm2.NWINDOWS


# ---------------------------------------------------------------------------
# Jacobian point ops under the JAX package's names.  `jac_add` is the
# elementwise K8a add (ops/cuda_mont.py), its plain version on CPU tensors.
# ---------------------------------------------------------------------------

def jac_identity(batch_shape=(), device="cuda"):
    shape = (NLIMBS,) + tuple(batch_shape)
    one = fq.const("ONE_MONT", device, len(shape)).expand(shape).contiguous()
    return (one, one, torch.zeros(shape, dtype=DTYPE, device=device))


def jac_from_affine(x, y):
    """Affine (Montgomery limbs) -> Jacobian with Z = 1."""
    return (x, y, fq.full("ONE_MONT", x))


def jac_double(p):
    """Jacobian doubling (one K7 launch on CUDA tensors)."""
    return jac_double_n(p, 1)


def _bit_reversed(k: int, device):
    """The permutation j -> j with its k low bits reversed, [2^k]."""
    idx = torch.arange(1 << k, device=device)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def jac_fold_sum(p):
    """Sum a Jacobian batch over its last axis: [16, *batch] (the identity
    for width 0, as the JAX package pads it to one identity).

    The JAX package's order: pad with identities to a power of two, then
    halve level by level, each level adding lanes (2j, 2j + 1).  On lanes
    in bit-reversed order those pairs are the two halves of every level, so
    after one gather each level is ONE elementwise add (K8a on the card) of
    two column views, with no copy of its operands."""
    X, Y, Z = p
    n = X.shape[-1]
    if n == 0:
        return jac_identity(X.shape[1:-1], X.device)
    k = (n - 1).bit_length()
    if (1 << k) != n:
        ident = jac_identity(X.shape[1:-1] + ((1 << k) - n,), X.device)
        X, Y, Z = (torch.cat([c, i], dim=-1) for c, i in zip((X, Y, Z), ident))
    rev = _bit_reversed(k, X.device)
    X, Y, Z = (c[..., rev] for c in (X, Y, Z))
    while X.shape[-1] > 1:
        h = X.shape[-1] // 2
        X, Y, Z = jac_add((X[..., :h], Y[..., :h], Z[..., :h]), (X[..., h:], Y[..., h:], Z[..., h:]))
    return X[..., 0], Y[..., 0], Z[..., 0]


# ---------------------------------------------------------------------------
# Host <-> device point conversion.
# ---------------------------------------------------------------------------

def points_to_device(points, device) -> tuple:
    """List of host affine G1 points (Fq pairs, no identities) -> mont limbs."""
    xs = fq.to_mont_host_many([int(p[0]) for p in points])
    ys = fq.to_mont_host_many([int(p[1]) for p in points])
    return to_device(xs, device), to_device(ys, device)


def jac_to_affine_host(p):
    """Single Jacobian device point -> host affine (Fq, Fq) or None."""
    from ..fields import Fq as HostFq

    X, Y, Z = (c.detach().cpu().numpy().reshape(NLIMBS) for c in p)
    z = fq.from_mont_host(Z)
    if z == 0:
        return None
    x = fq.from_mont_host(X)
    y = fq.from_mont_host(Y)
    zinv = pow(z, -1, FQ_MOD)
    return (HostFq(x * zinv * zinv), HostFq(y * zinv * zinv * zinv))


def _digits_impl(raw_scalars):
    """Canonical limbs [16, n] -> window-major flattened 8-bit digits
    [32n]; [16, B, n] -> [B, 32n]."""
    r = raw_scalars.movedim(0, -2)  # [..., 16, n]
    return torch.stack([r & 0xFF, r >> 8], dim=-2).reshape(r.shape[:-2] + (-1,))


def _coeff_digits(coeffs_mont):
    """Montgomery coefficients [16, m] -> window-major 8-bit digits [32m];
    [16, B, m] -> [B, 32m]."""
    return _digits_impl(fr.from_mont(coeffs_mont))


# ---------------------------------------------------------------------------
# The SRS checkpoint cache: .npz files beside a caller's prefix.
# ---------------------------------------------------------------------------

def _srs_digest(points) -> str:
    """Content digest of an SRS point list, for keying window-table caches.

    A count-only check would accept stale tables from a different SRS of
    the same size (a synthetic setup with another tau), and every commit
    after it would be wrong.  Hashes n, a deterministic sample of at most
    4096 points and the last point: any tau change alters every
    non-generator point, so the sample catches a mismatch."""
    n = len(points)
    h = hashlib.sha256()
    h.update(str(n).encode())
    step = max(1, n // 4096)
    for p in points[0:n:step] + points[-1:]:
        h.update(int(p[0]).to_bytes(32, "little"))
        h.update(int(p[1]).to_bytes(32, "little"))
    return h.hexdigest()


def as_int32(a) -> np.ndarray:
    """A limb or packed-word array of either package (int32, or the JAX
    package's uint32) as int32 with the same 32 bits, converted by value."""
    a = np.asarray(a)
    if a.dtype == np.int32:
        return a
    a = a.astype(np.int64)
    return (((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)


def save_npz(path: str, **arrays) -> None:
    """np.savez (uncompressed) to a temporary file beside `path`, then
    os.replace: a process reading the same prefix never sees half a file."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


# Table cache kinds: file-name infix -> (arrays, columns per base point).
_TABLE_KINDS = {"affine": (("AX", "AY"), NWINDOWS), "affine16p_": (("P",), msm3.NW)}


# ---------------------------------------------------------------------------
# Fixed-base MSM.
# ---------------------------------------------------------------------------

class FixedBaseMSM:
    """Fixed-base MSM context over the SRS G1 powers (the KZG commit engine).

    Builds affine window tables on the device, packed 16-bit ones for the
    msm3 pipeline and 8-bit ones for msm2, each at first use.  Tables cover
    the first `_need(m)` bases, a power of two plus 3 grown on demand up
    to the SRS size, so a small circuit on a large SRS does not pay for the
    whole table.

    With `cache_path`, tables are read from and written to
    `{cache_path}.affine{w}.npz` (msm2's x and y tables, [16, 32w]) and
    `{cache_path}.affine16p_{w}.npz` (msm3's packed table, [16, 16w]), each
    keyed by the SRS digest, n and the width w it covers: a build first
    takes the widest file of this SRS at least `_need(m)` wide, and writes
    what it builds.  A stale, foreign, too narrow or unreadable file is a
    miss, as in the JAX package.
    """

    _MSM3_MIN = 8192  # smallest m routed to the 16-bit-window pipeline

    def __init__(self, points, device="cuda", cache_path=None):
        """points: list of host affine G1 points (the SRS powers of x), or
        a pair (x, y) of affine Montgomery limbs [16, n] on the engine's
        device (`msm_variable_base`; no cache)."""
        self._limbs = tuple(points) if torch.is_tensor(points[0]) else None
        if self._limbs is not None:
            if cache_path is not None:
                raise ValueError("the table cache is keyed by host SRS points")
            device = self._limbs[0].device
        self.n = len(points) if self._limbs is None else self._limbs[0].shape[1]
        self._points = points
        self.device = torch.device(device)
        self.cache_path = cache_path
        self._digest = _srs_digest(points) if cache_path is not None else None
        self.affine_tab = None    # 8-bit affine tables (msm2)
        self._tab_n = 0
        self.affine16_tab = None  # packed 16-bit tables (msm3)
        self._tab16_n = 0

    def block(self, cols: slice, cache_path, device) -> "FixedBaseMSM":
        """A FixedBaseMSM over this engine's points [cols] on `device`,
        with its own table cache prefix (a mesh rank's block)."""
        if self._limbs is not None:
            return FixedBaseMSM(tuple(c[:, cols].to(device) for c in self._limbs))
        return FixedBaseMSM(self._points[cols], device=device, cache_path=cache_path)

    def _need(self, m: int) -> int:
        """Bases the tables must cover for a commit of m <= n coefficients:
        the next power of two at or above m - 3, plus the 3 coefficients a
        ZK-blinded commit adds to a power-of-two width, and at most the
        SRS.  So the first commit of n on an SRS of n + 3 powers or more
        builds tables n + 3 wide, and the blinded commits of n + 2 and
        n + 3 coefficients need no second build."""
        return min(self.n, (1 << max(m - 4, 0).bit_length()) + 3)

    def _bases(self, need: int):
        """Affine Montgomery limbs of the first `need` bases on the device."""
        if self._limbs is not None:
            return tuple(c[:, :need] for c in self._limbs)
        return points_to_device(self._points[:need], self.device)

    def _cache_file(self, kind: str, w: int) -> str:
        return f"{self.cache_path}.{kind}{w}.npz"

    def _load_tables(self, kind: str, need: int):
        """(w, tables on the device) from the widest readable cache file of
        this SRS at least `need` wide, or None."""
        if self.cache_path is None:
            return None
        names, cols = _TABLE_KINDS[kind]
        folder = os.path.dirname(self.cache_path) or "."
        pattern = re.compile(re.escape(f"{os.path.basename(self.cache_path)}.{kind}") + r"(\d+)\.npz")
        try:
            found = [pattern.fullmatch(f) for f in os.listdir(folder)]
        except OSError:
            return None
        for w in sorted((int(f.group(1)) for f in found if f), reverse=True):
            if w < need:
                break
            try:
                with np.load(self._cache_file(kind, w)) as data:
                    if (int(data["n"]) != self.n or int(data["w"]) != w
                            or str(data["digest"]) != self._digest):
                        continue
                    tabs = [as_int32(data[k]) for k in names]
            except (OSError, KeyError, ValueError):
                continue
            if all(t.shape == (NLIMBS, cols * w) for t in tabs):
                return w, tuple(torch.from_numpy(t).to(self.device) for t in tabs)
        return None

    def _save_tables(self, kind: str, w: int, tabs) -> None:
        if self.cache_path is None:
            return
        names, _ = _TABLE_KINDS[kind]
        arrays = {k: t.cpu().numpy() for k, t in zip(names, tabs)}
        try:
            save_npz(self._cache_file(kind, w), n=self.n, w=w, digest=self._digest, **arrays)
        except OSError:
            pass

    def _build_affine(self, m: int):
        need = self._need(m)
        if self._tab_n >= need:
            return
        hit = self._load_tables("affine", need)
        if hit is None:
            tabs = msm2.build_affine_tables(*self._bases(need))
            self._save_tables("affine", need, tabs)
            hit = need, tabs
        self._tab_n, self.affine_tab = hit

    def _build_affine16(self, m: int):
        need = self._need(m)
        if self._tab16_n >= need:
            return
        hit = self._load_tables("affine16p_", need)
        if hit is None:
            tab = msm3.build_affine_tables16(*self._bases(need))
            self._save_tables("affine16p_", need, (tab,))
            hit = need, (tab,)
        self._tab16_n, (self.affine16_tab,) = hit

    def _tables_for(self, m: int):
        self._build_affine(m)
        tabx, taby = self.affine_tab
        if m != self._tab_n:
            idx = (
                torch.arange(NWINDOWS, device=self.device)[:, None] * self._tab_n
                + torch.arange(m, device=self.device)[None, :]
            ).reshape(-1)
            tabx, taby = tabx[:, idx], taby[:, idx]
        return tabx, taby

    def precomp_for(self, m: int):
        """msm2's window tables of the first m bases, window-major
        [16, 32m], as a Jacobian triple with Z = 1 (Montgomery)."""
        tabx, taby = self._tables_for(m)
        return jac_from_affine(tabx, taby)

    def _digits16(self, coeffs_mont):
        """Montgomery coefficients [16, m] -> msm3 signed keys / payloads."""
        return msm3.signed_digits16(fr.from_mont(coeffs_mont), self._tab16_n)

    def _msm2_stacked(self, coeffs_mont):
        """MSM through the 8-bit pipeline: [16, m] -> [48] Jacobian limbs;
        [16, B, m] (B commits of one width) -> [B, 48] in one pipeline."""
        tabx, taby = self._tables_for(coeffs_mont.shape[-1])
        return msm2.msm_fixed_affine(tabx, taby, _coeff_digits(coeffs_mont))

    def _deferred_all(self, coeff_list):
        """`msm_mont_deferred` of each row, but the msm2-route rows of one
        width go through ONE batched pipeline (a group of one as it is):
        fewer, wider calls, each commit's lanes and result the same."""
        outs = [None] * len(coeff_list)
        groups: dict = {}
        for i, coeffs in enumerate(coeff_list):
            m = coeffs.shape[-1]
            if m >= self._MSM3_MIN or m > self.n:
                outs[i] = self.msm_mont_deferred(coeffs)
            else:
                groups.setdefault(m, []).append(i)
        for idx in groups.values():
            if len(idx) == 1:
                outs[idx[0]] = (self._msm2_stacked(coeff_list[idx[0]]), None)
                continue
            res = self._msm2_stacked(torch.stack([coeff_list[i] for i in idx], dim=1))
            for j, i in enumerate(idx):
                outs[i] = (res[j], None)
        return outs

    def msm_mont_deferred(self, coeffs_mont):
        """Device-side MSM of Montgomery coefficients [16, m], m <= n:
        ([48] Jacobian limbs, maxmult or None), no host synchronization.

        On the msm3 route the result only stands if the returned bucket
        multiplicity (a 0-dim device tensor) is at most `msm3._J`; the
        caller fetches it, with the result, and recommits through msm2
        otherwise.  On the msm2 route it is None."""
        m = coeffs_mont.shape[-1]
        if m > self.n:
            raise ValueError("polynomial degree exceeds SRS size")
        if m >= self._MSM3_MIN:
            self._build_affine16(m)
            key, payload = self._digits16(coeffs_mont)
            return msm3.msm_fixed_affine16(self.affine16_tab, key, payload)
        return self._msm2_stacked(coeffs_mont), None

    def msm_mont(self, coeffs_mont):
        """MSM -> a Jacobian triple of [16] limbs on the device.  Fetches
        msm3's multiplicity and recommits through msm2 above `msm3._J`."""
        res, maxmult = self.msm_mont_deferred(coeffs_mont)
        if maxmult is not None and int(maxmult) > msm3._J:
            res = self._msm2_stacked(coeffs_mont)
        return unstack_points(res, ())

    def commit_mont(self, coeffs_mont):
        """MSM -> host affine point (or None for the zero polynomial)."""
        return self.commit_batch([coeffs_mont])[0]

    def commit_many_mont(self, coeffs_mont):
        """[16, M, m] Montgomery coefficients -> M host affine points, in
        one `commit_batch` (one host fetch)."""
        return self.commit_batch([coeffs_mont[:, i] for i in range(coeffs_mont.shape[1])])

    def commit_batch(self, coeff_list):
        """Commit several polynomials with ONE host fetch: the stacked
        results and msm3's multiplicities come back together.  A
        multiplicity above `msm3._J` (pathological digit concentration: more
        same-bucket runs than the dense gather folds) is rare; such a
        polynomial is recommitted through msm2 afterwards.  The msm2-route
        polynomials of one width share one pipeline (`_deferred_all`)."""
        outs = self._deferred_all(coeff_list)
        zero = torch.zeros((), dtype=DTYPE, device=self.device)
        rows = torch.stack([
            torch.cat([res, (zero if mm is None else mm.to(DTYPE))[None]])
            for res, mm in outs
        ]).cpu()
        pts = []
        for coeffs, row in zip(coeff_list, rows):
            res = row[: 3 * NLIMBS]
            if int(row[3 * NLIMBS]) > msm3._J:
                res = self._msm2_stacked(coeffs)
            pts.append(jac_to_affine_host(res.reshape(3, NLIMBS)))
        return pts


def msm_variable_base(points, scalars_mont):
    """Variable-base device MSM: points (x, y) affine Montgomery limbs
    [16, n] on the device, scalars [16, n] -> a Jacobian triple of [16]
    limbs.  Builds window tables for these points (K7; no cache) and
    commits on the route a `FixedBaseMSM` takes for that m."""
    return FixedBaseMSM(points).msm_mont(scalars_mont)
