"""Device polynomials over Fr on torch tensors.

A polynomial is a limb-major int32[16, n] tensor in Montgomery form on an
explicit device, in either basis:

* LAGRANGE — evaluations at the order-n roots-of-unity domain,
* MONOMIAL — coefficients.

Pointwise algebra dispatches to the batched field ops (ops/limbs.py) and
basis changes to the NTT (ops/ntt.py).  Scalars at the API boundary are
host `Fr` values.
"""

from __future__ import annotations

from enum import Enum

import torch

from .fields import Fr, FR_MOD
from .ops.limbs import fr, NLIMBS, DTYPE, to_device, resolve_device
from .ops import ntt as _ntt


class Basis(Enum):
    LAGRANGE = 1
    MONOMIAL = 2


_OPS = {
    "add": fr.add,
    "sub": fr.sub,
    "mul": fr.mul,
    "div": lambda a, b: fr.mul(a, fr.inv(b)),
}


class Polynomial:
    __slots__ = ("values", "basis")

    def __init__(self, values, basis: Basis, device="cuda"):
        """values: int32[16, n] Montgomery limbs (a tensor, whose device
        is kept), or a list of Fr/int placed on `device`."""
        if isinstance(values, (list, tuple)):
            values = to_device(
                fr.to_mont_host_many([int(v) for v in values]), resolve_device(device)
            )
        assert values.ndim == 2 and values.shape[0] == NLIMBS
        self.values = values
        self.basis = basis

    @property
    def device(self) -> torch.device:
        return self.values.device

    # -- construction -----------------------------------------------------
    @classmethod
    def zeros(cls, n: int, basis: Basis = Basis.LAGRANGE, device="cuda") -> "Polynomial":
        return cls(torch.zeros((NLIMBS, n), dtype=DTYPE, device=resolve_device(device)), basis)

    def __len__(self) -> int:
        return int(self.values.shape[1])

    def to_ints(self) -> list[int]:
        return fr.from_mont_host_many(self.values)

    def to_scalars(self) -> list[Fr]:
        return [Fr(v) for v in self.to_ints()]

    # -- comparison -------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, Polynomial):
            return NotImplemented
        return self.basis == other.basis and bool(
            torch.equal(fr.canon(self.values), fr.canon(other.values))
        )

    # -- algebra ----------------------------------------------------------
    def _scalar(self, v):
        return fr.scalar(int(v), self.device).reshape(NLIMBS, 1)

    def _pointwise(self, other, opname):
        op = _OPS[opname]
        if isinstance(other, Polynomial):
            assert self.basis == other.basis
            assert self.values.shape == other.values.shape
            return Polynomial(op(self.values, other.values), self.basis)
        s = self._scalar(other)
        if self.basis == Basis.LAGRANGE or opname in ("mul", "div"):
            return Polynomial(op(self.values, s), self.basis)
        # MONOMIAL +/- scalar touches only the constant coefficient.
        head = op(self.values[:, :1], s)
        return Polynomial(torch.cat([head, self.values[:, 1:]], dim=1), self.basis)

    def __add__(self, other):
        return self._pointwise(other, "add")

    def __sub__(self, other):
        return self._pointwise(other, "sub")

    def __rsub__(self, other):
        return Polynomial(fr.neg(self.values), self.basis) + other

    def __mul__(self, other):
        if isinstance(other, Polynomial):
            assert self.basis == Basis.LAGRANGE and other.basis == Basis.LAGRANGE
        return self._pointwise(other, "mul")

    __rmul__ = __mul__
    __radd__ = __add__

    def __truediv__(self, other):
        if isinstance(other, Polynomial):
            assert self.basis == Basis.LAGRANGE and other.basis == Basis.LAGRANGE
            return self._pointwise(other, "div")
        inv = Fr(pow(int(other), -1, FR_MOD))
        return self._pointwise(inv, "mul")

    def __neg__(self):
        return Polynomial(fr.neg(self.values), self.basis)

    # -- structure --------------------------------------------------------
    def shift(self, k: int) -> "Polynomial":
        """Cyclic left rotation of Lagrange values: p(x) -> p(omega^k x)."""
        if self.basis != Basis.LAGRANGE:
            raise ValueError("shift rotates Lagrange values")
        return Polynomial(torch.roll(self.values, -k, dims=1), self.basis)

    # -- basis changes ----------------------------------------------------
    def fft(self, inv: bool = False) -> "Polynomial":
        if inv:
            assert self.basis == Basis.LAGRANGE
            return Polynomial(_ntt.ntt(self.values, inverse=True), Basis.MONOMIAL)
        assert self.basis == Basis.MONOMIAL
        return Polynomial(_ntt.ntt(self.values), Basis.LAGRANGE)

    def ifft(self) -> "Polynomial":
        return self.fft(True)

    def to_coset_extended_lagrange(self, offset) -> "Polynomial":
        """Values on the n domain -> values on the offset*q^i 4n coset."""
        assert self.basis == Basis.LAGRANGE
        off = fr.scalar(int(offset), self.device)
        return Polynomial(_ntt.coset_extend(self.values, off), Basis.LAGRANGE)

    def coset_extended_lagrange_to_coeffs(self, offset) -> "Polynomial":
        """Values on the offset*q^i 4n coset -> monomial coefficients."""
        assert self.basis == Basis.LAGRANGE
        offinv = fr.scalar(pow(int(offset), -1, FR_MOD), self.device)
        return Polynomial(_ntt.coset_to_coeffs(self.values, offinv), Basis.MONOMIAL)

    # -- evaluation -------------------------------------------------------
    def barycentric_eval(self, x) -> Fr:
        """Evaluate Lagrange values at an arbitrary host scalar."""
        assert self.basis == Basis.LAGRANGE
        xl = fr.scalar(int(x), self.device)
        return Fr(fr.from_mont_host(_ntt.barycentric_eval(self.values, xl)))
