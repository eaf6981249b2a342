"""Number-theoretic transform over Fr on torch tensors.

Counterpart of the JAX package's `ops/ntt.py`: a constant-geometry
Stockham DIF NTT, log2(n) butterfly stages of static halves-splits with no
gathers and no bit reversal, for n < 2^14, and the four-step transform
(`ops/ntt_fourstep.py`) from there up.  Every stage of either is one
`dif_butterfly` call (`ops/cuda_mont.py`), which launches the K2 kernel on
CUDA tensors and runs its plain version on CPU tensors, so both devices
take the same route and the same stages.

Also the coset-extension transforms (the prover's 4n evaluation domain),
scalar power tables and barycentric evaluation.  Outputs are exact integers
mod p, identical to any correct DFT.
"""

from __future__ import annotations

import torch

from ..fields import FR_MOD
from .limbs import fr, NLIMBS, DTYPE
from .cuda_mont import dif_butterfly


def _root_host(n: int, inverse: bool) -> int:
    w = pow(5, (FR_MOD - 1) // n, FR_MOD)
    return pow(w, -1, FR_MOD) if inverse else w


def scalar_powers(offset, n: int):
    """[1, offset, offset^2, ..., offset^(n-1)] in Montgomery form.

    offset: int32[16] (Montgomery).  Log-depth doubling construction."""
    pw = fr.const("ONE_MONT", offset.device, 2)
    length = 1
    while length < n:
        step = pw[:, length - 1 : length]
        top = fr.mul(step, offset[:, None])  # offset^length
        ext = fr.mul(pw, top)
        pw = torch.cat([pw, ext], dim=1)
        length *= 2
    return pw[:, :n]


def _roots_impl(n: int, inverse: bool, device):
    """Device powers [1, w, ..., w^(n-1)] of the order-n domain generator."""
    return scalar_powers(fr.scalar(_root_host(n, inverse), device), n)


# From this size up a transform takes the four-step route.
_FOURSTEP_MIN = 1 << 14


def ntt(values, inverse: bool = False):
    """DFT over the order-n subgroup of Fr on the LAST axis.

    values: int32[16, *batch, n] Montgomery.  Forward: coefficients ->
    evaluations at [1, w, w^2, ...]; inverse: evaluations -> coefficients.
    """
    n = values.shape[-1]
    if n >= _FOURSTEP_MIN:
        from .ntt_fourstep import ntt_fourstep

        return ntt_fourstep(values, n, inverse)
    return _ntt_stockham(values, inverse)


def _ntt_stockham(values, inverse: bool):
    """The last-axis Stockham DIF transform (any power-of-two n)."""
    n = values.shape[-1]
    if n == 1:
        return values
    tw_all = _roots_impl(n, inverse, values.device)  # [16, n]
    batch = values.shape[1:-1]
    nb = len(batch)
    a = values
    l, m = n // 2, 1
    while l >= 1:
        x = a.reshape(values.shape[:-1] + (2, l, m))
        tw = tw_all[:, : l * m : m].reshape((NLIMBS,) + (1,) * nb + (l, 1))
        s, d = dif_butterfly(x[..., 0, :, :], x[..., 1, :, :], tw)
        a = torch.stack([s, d], dim=-2).reshape(values.shape)  # [..., l, 2, m]
        l //= 2
        m *= 2
    if inverse:
        ninv = fr.scalar(pow(n, -1, FR_MOD), values.device)
        a = fr.mul(a, ninv.reshape((NLIMBS,) + (1,) * (nb + 1)))
    return a


# ---------------------------------------------------------------------------
# Coset-extended domain transforms (prover's 4n evaluation form).
# ---------------------------------------------------------------------------

def coset_extend(values, offset):
    """Lagrange values on the n-domain -> values on the offset*q^i 4n-coset.

    values: int32[16, n] mont; offset: int32[16] mont."""
    n = values.shape[-1]
    coeffs = ntt(values, inverse=True)
    scaled = fr.mul(coeffs, scalar_powers(offset, n))
    padded = torch.cat(
        [scaled, torch.zeros((NLIMBS, 3 * n), dtype=DTYPE, device=values.device)],
        dim=1,
    )
    return ntt(padded)


def coset_to_coeffs(values, offset_inv):
    """Values on the 4n coset -> monomial coefficients (length 4n); takes
    offset^-1 (Montgomery)."""
    n4 = values.shape[-1]
    shifted = ntt(values, inverse=True)
    return fr.mul(shifted, scalar_powers(offset_inv, n4))


# ---------------------------------------------------------------------------
# Barycentric evaluation.
# ---------------------------------------------------------------------------

def _treesum(vec):
    """Sum over the last axis of int32[16, ..., n] (n a power of two)."""
    n = vec.shape[-1]
    while n > 1:
        half = n // 2
        vec = fr.add(vec[..., :half], vec[..., half : 2 * half])
        n = half
    return vec[..., 0]


def barycentric_eval(values, x):
    """Evaluate Lagrange-basis values (int32[16, n] mont) at x (int32[16]
    mont); undefined if x is a domain point."""
    n = values.shape[-1]
    roots = _roots_impl(n, False, values.device)
    denom = fr.sub(x[:, None], roots)
    terms = fr.mul(fr.mul(values, roots), fr.batch_inv(denom))
    total = _treesum(terms)
    xn = fr.pow_int(x, n)
    scale = fr.mul(
        fr.sub(xn, fr.const("ONE_MONT", x.device)),
        fr.scalar(pow(n, -1, FR_MOD), x.device),
    )
    return fr.mul(total, scale)
