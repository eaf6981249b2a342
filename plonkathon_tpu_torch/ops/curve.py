"""Batched G1 Jacobian arithmetic and the fixed-base MSM engine.

Counterpart of the JAX package's `ops/curve.py`, with the affine 8-bit
(msm2) route only: every commit goes through `ops/msm2.py` on both devices.

Points are structure-of-arrays Jacobian coordinates over Fq limb tensors
(int32[16, *batch], Montgomery form); the identity is Z == 0.
"""

from __future__ import annotations

import torch

from ..fields import FQ_MOD
from .limbs import fq, fr, NLIMBS, DTYPE, to_device
from .cuda_mont import _kern_add, _kern_double
from . import msm2

WINDOW_BITS = msm2.WINDOW_BITS
NWINDOWS = msm2.NWINDOWS


# ---------------------------------------------------------------------------
# Jacobian point ops (X, Y, Z limb-major tuples; Montgomery domain).
# ---------------------------------------------------------------------------

def jac_identity(batch_shape=(), device="cpu"):
    zero = torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=DTYPE, device=device)
    one = fq.full("ONE_MONT", zero)
    return (one, one, zero)


def jac_double(p):
    """Jacobian doubling for y^2 = x^3 + b (a = 0).  Identity-safe (Z3=0)."""
    return _kern_double(fq, p)


def jac_add(p, q):
    """Complete Jacobian addition (handles identity, equal, and inverse pairs)."""
    return _kern_add(fq, p, q)


def jac_fold_sum(p):
    """Sum a Jacobian point batch over its last axis (pairwise halving with
    identity padding to a power of two)."""
    X, Y, Z = p
    n = X.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        iX, iY, iZ = jac_identity(X.shape[1:-1] + (m - n,), X.device)
        X, Y, Z = (torch.cat([a, b], dim=-1) for a, b in ((X, iX), (Y, iY), (Z, iZ)))
    while m > 1:
        X, Y, Z = jac_add(
            (X[..., 0::2], Y[..., 0::2], Z[..., 0::2]),
            (X[..., 1::2], Y[..., 1::2], Z[..., 1::2]),
        )
        m //= 2
    return (X[..., 0], Y[..., 0], Z[..., 0])


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

    Builds affine 8-bit window tables on the device and commits through the
    msm2 pipeline (`ops/msm2.py`).  Tables cover the first `_tab_n` bases,
    a power of two grown on demand up to the SRS size, so a small circuit on
    a large SRS does not pay for the whole table.
    """

    def __init__(self, points, device="cuda"):
        """points: list of host affine G1 points (the SRS powers of x)."""
        self.n = len(points)
        self._points = points
        self.device = torch.device(device)
        self.affine_tab = None
        self._tab_n = 0

    def _build_affine(self, m: int):
        need = min(self.n, 1 << max(m - 1, 0).bit_length())
        if self._tab_n >= need:
            return
        x, y = points_to_device(self._points[:need], self.device)
        self.affine_tab = msm2.build_affine_tables(x, y)
        self._tab_n = need

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

    def msm_stacked(self, coeffs_mont):
        """MSM with Montgomery coefficients [16, m], m <= n -> [48] Jacobian
        limbs on the device (no host synchronization)."""
        m = coeffs_mont.shape[-1]
        if m > self.n:
            raise ValueError("polynomial degree exceeds SRS size")
        tabx, taby = self._tables_for(m)
        return msm2.msm_fixed_affine(tabx, taby, _coeff_digits(coeffs_mont))

    def msm_mont(self, coeffs_mont):
        res = self.msm_stacked(coeffs_mont)
        return (res[:NLIMBS], res[NLIMBS : 2 * NLIMBS], res[2 * NLIMBS :])

    def commit_mont(self, coeffs_mont):
        """MSM -> host affine point (or None for the zero polynomial)."""
        return jac_to_affine_host(self.msm_mont(coeffs_mont))

    def commit_batch(self, coeff_list):
        """Commit several polynomials with ONE host fetch."""
        stack = torch.stack([self.msm_stacked(c) for c in coeff_list]).cpu()
        return [
            jac_to_affine_host((row[:NLIMBS], row[NLIMBS : 2 * NLIMBS], row[2 * NLIMBS :]))
            for row in stack
        ]
