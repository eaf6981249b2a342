"""G1 point conversion and the fixed-base MSM engine.

Counterpart of the JAX package's `ops/curve.py`.  A commit of m >= 8192
coefficients goes through the signed 16-bit-window pipeline (`ops/msm3.py`)
and falls through to the 8-bit pipeline (`ops/msm2.py`) if msm3 reports a
bucket multiplicity above what its dense stage folds; smaller commits take
msm2 directly.  The route depends on m alone, not on the device.

Points are structure-of-arrays Jacobian coordinates over Fq limb tensors
(int32[16, *batch], Montgomery form); the identity is Z == 0.
"""

from __future__ import annotations

import torch

from ..fields import FQ_MOD
from .limbs import fq, fr, NLIMBS, DTYPE, to_device
from . import msm2, msm3

WINDOW_BITS = msm2.WINDOW_BITS
NWINDOWS = msm2.NWINDOWS


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
    """Canonical limbs [16, n] -> window-major flattened 8-bit digits [32n]."""
    lo = raw_scalars & 0xFF
    hi = raw_scalars >> 8
    return torch.stack([lo, hi], dim=1).reshape(-1)


def _coeff_digits(coeffs_mont):
    """Montgomery coefficients [16, m] -> window-major 8-bit digits [32m]."""
    return _digits_impl(fr.from_mont(coeffs_mont))


# ---------------------------------------------------------------------------
# Fixed-base MSM.
# ---------------------------------------------------------------------------

class FixedBaseMSM:
    """Fixed-base MSM context over the SRS G1 powers (the KZG commit engine).

    Builds affine window tables on the device, packed 16-bit ones for the
    msm3 pipeline and 8-bit ones for msm2, each at first use.  Tables cover
    the first `need` bases, a power of two grown on demand up to the SRS
    size, so a small circuit on a large SRS does not pay for the whole
    table.
    """

    _MSM3_MIN = 8192  # smallest m routed to the 16-bit-window pipeline

    def __init__(self, points, device="cuda"):
        """points: list of host affine G1 points (the SRS powers of x)."""
        self.n = len(points)
        self._points = points
        self.device = torch.device(device)
        self.affine_tab = None    # 8-bit affine tables (msm2)
        self._tab_n = 0
        self.affine16_tab = None  # packed 16-bit tables (msm3)
        self._tab16_n = 0

    def _need(self, m: int) -> int:
        return min(self.n, 1 << max(m - 1, 0).bit_length())

    def _build_affine(self, m: int):
        need = self._need(m)
        if self._tab_n >= need:
            return
        x, y = points_to_device(self._points[:need], self.device)
        self.affine_tab = msm2.build_affine_tables(x, y)
        self._tab_n = need

    def _build_affine16(self, m: int):
        need = self._need(m)
        if self._tab16_n >= need:
            return
        x, y = points_to_device(self._points[:need], self.device)
        self.affine16_tab = msm3.build_affine_tables16(x, y)
        self._tab16_n = need

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

    def _digits16(self, coeffs_mont):
        """Montgomery coefficients [16, m] -> msm3 signed keys / payloads."""
        return msm3.signed_digits16(fr.from_mont(coeffs_mont), self._tab16_n)

    def _msm2_stacked(self, coeffs_mont):
        """MSM through the 8-bit pipeline -> [48] Jacobian limbs."""
        tabx, taby = self._tables_for(coeffs_mont.shape[-1])
        return msm2.msm_fixed_affine(tabx, taby, _coeff_digits(coeffs_mont))

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

    def commit_mont(self, coeffs_mont):
        """MSM -> host affine point (or None for the zero polynomial)."""
        return self.commit_batch([coeffs_mont])[0]

    def commit_batch(self, coeff_list):
        """Commit several polynomials with ONE host fetch: the stacked
        results and msm3's multiplicities come back together.  A
        multiplicity above `msm3._J` (pathological digit concentration: more
        same-bucket runs than the dense gather folds) is rare; such a
        polynomial is recommitted through msm2 afterwards."""
        outs = [self.msm_mont_deferred(c) for c in coeff_list]
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
