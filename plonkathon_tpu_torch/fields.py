"""Host-side BN254 field tower: Fr, Fq, Fq2, Fq6, Fq12.

This is the *cold path* (transcript scalars, verifier pairings, test oracles).
The hot path lives in `plonkathon_tpu_torch.ops` as torch limb tensors and CUDA kernels.

Functional parity targets (the original plonkathon reference):
  - curve.py:10-24  (Scalar / roots of unity, primitive root 5)
  - py_ecc bn128 FQ/FQ2/FQ12 semantics (external dep of the reference),
    re-implemented here from the standard BN254 construction.
"""

from __future__ import annotations

# BN254 ("alt_bn128") base-field and scalar-field moduli.
FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Generator of Fr's multiplicative group used to derive roots of unity
# (reference curve.py:5 `primitive_root = 5`).
FR_GENERATOR = 5

# BN parameter x (curve family parameter); ate loop count = 6x + 2.
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288


class PrimeFieldElement:
    """An element of a prime field, stored as a canonical int `n`.

    Pickle-compatible with the layout the reference proof fixture uses
    (objects restored by attribute dict {"n": int}).
    """

    modulus: int = 0

    def __init__(self, value=0):
        if isinstance(value, PrimeFieldElement):
            value = value.n
        self.n = value % self.modulus

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, PrimeFieldElement):
            return other.n
        if isinstance(other, int):
            return other
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n + o)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n - o)

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(o - self.n)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n * o)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(self.n * pow(o, -1, self.modulus))

    def __rtruediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return type(self)(o * pow(self.n, -1, self.modulus))

    def __pow__(self, exponent: int):
        return type(self)(pow(self.n, int(exponent), self.modulus))

    def __neg__(self):
        return type(self)(-self.n)

    def inv(self):
        return type(self)(pow(self.n, -1, self.modulus))

    # -- comparison / hashing --------------------------------------------
    def __eq__(self, other):
        if isinstance(other, PrimeFieldElement):
            return self.n == other.n and self.modulus == other.modulus
        if isinstance(other, int):
            return self.n == other % self.modulus
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    def __hash__(self):
        return hash((self.modulus, self.n))

    def __int__(self):
        return self.n

    def __repr__(self):
        return f"{type(self).__name__}({self.n})"

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)


class Fq(PrimeFieldElement):
    """BN254 base field element."""

    modulus = FQ_MOD
    field_modulus = FQ_MOD  # alias for ecosystem familiarity


class Fr(PrimeFieldElement):
    """BN254 scalar field element (the PLONK "Scalar").

    Roots-of-unity API mirrors reference curve.py:13-24.
    """

    modulus = FR_MOD
    field_modulus = FR_MOD

    @classmethod
    def root_of_unity(cls, group_order: int) -> "Fr":
        assert (cls.modulus - 1) % group_order == 0
        return cls(pow(FR_GENERATOR, (cls.modulus - 1) // group_order, cls.modulus))

    @classmethod
    def roots_of_unity(cls, group_order: int) -> list["Fr"]:
        w = cls.root_of_unity(group_order)
        out = [cls(1)]
        for _ in range(group_order - 1):
            out.append(out[-1] * w)
        return out


# Back-compat name used across the protocol layer: the PLONK scalar.
Scalar = Fr


# ---------------------------------------------------------------------------
# Extension tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - xi), xi = 9 + u;
# Fq12 = Fq6[w]/(w^2 - v).  Elements are stored as tuples of ints for speed.
# ---------------------------------------------------------------------------

_P = FQ_MOD


def _fq2_add(a, b):
    return ((a[0] + b[0]) % _P, (a[1] + b[1]) % _P)


def _fq2_sub(a, b):
    return ((a[0] - b[0]) % _P, (a[1] - b[1]) % _P)


def _fq2_neg(a):
    return ((-a[0]) % _P, (-a[1]) % _P)


def _fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % _P, (t2 - t0 - t1) % _P)


def _fq2_sqr(a):
    return _fq2_mul(a, a)


def _fq2_scalar(a, k):
    return ((a[0] * k) % _P, (a[1] * k) % _P)


def _fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % _P
    ninv = pow(norm, -1, _P)
    return ((a[0] * ninv) % _P, ((-a[1]) * ninv) % _P)


def _fq2_conj(a):
    return (a[0], (-a[1]) % _P)


def _fq2_pow(a, e):
    result = (1, 0)
    base = a
    while e > 0:
        if e & 1:
            result = _fq2_mul(result, base)
        base = _fq2_sqr(base)
        e >>= 1
    return result


# Non-residue xi = 9 + u used to build Fq6.
_XI = (9, 1)


def _fq2_mul_xi(a):
    # (a0 + a1 u)(9 + u) = (9 a0 - a1) + (a0 + 9 a1) u
    return ((9 * a[0] - a[1]) % _P, (a[0] + 9 * a[1]) % _P)


class Fq2:
    """BN254 quadratic extension element, py_ecc-FQ2-compatible surface.

    Stored as .coeffs = [c0, c1] ints meaning c0 + c1*u.
    """

    def __init__(self, coeffs):
        c0, c1 = coeffs
        self.coeffs = [int(c0) % _P, int(c1) % _P]

    def _t(self):
        return (self.coeffs[0], self.coeffs[1])

    @classmethod
    def _from_t(cls, t):
        return cls([t[0], t[1]])

    def __add__(self, other):
        return Fq2._from_t(_fq2_add(self._t(), other._t()))

    def __sub__(self, other):
        return Fq2._from_t(_fq2_sub(self._t(), other._t()))

    def __neg__(self):
        return Fq2._from_t(_fq2_neg(self._t()))

    def __mul__(self, other):
        if isinstance(other, Fq2):
            return Fq2._from_t(_fq2_mul(self._t(), other._t()))
        if isinstance(other, (int, Fq)):
            return Fq2._from_t(_fq2_scalar(self._t(), int(other)))
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Fq2):
            return Fq2._from_t(_fq2_mul(self._t(), _fq2_inv(other._t())))
        if isinstance(other, (int, Fq)):
            return Fq2._from_t(_fq2_scalar(self._t(), pow(int(other), -1, _P)))
        return NotImplemented

    def __pow__(self, e):
        return Fq2._from_t(_fq2_pow(self._t(), int(e)))

    def inv(self):
        return Fq2._from_t(_fq2_inv(self._t()))

    def __eq__(self, other):
        if isinstance(other, Fq2):
            return self.coeffs == other.coeffs
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    def __hash__(self):
        return hash(("Fq2", self.coeffs[0], self.coeffs[1]))

    def __repr__(self):
        return f"Fq2({self.coeffs})"

    @classmethod
    def zero(cls):
        return cls([0, 0])

    @classmethod
    def one(cls):
        return cls([1, 0])


# ---------------------------------------------------------------------------
# Fq6 / Fq12 as tuple-based functional arithmetic (internal to the pairing).
# Fq6 element: (c0, c1, c2) with ci in Fq2-tuples; means c0 + c1 v + c2 v^2.
# Fq12 element: (a, b) with a, b in Fq6; means a + b w.
# ---------------------------------------------------------------------------

_FQ6_ZERO = ((0, 0), (0, 0), (0, 0))
_FQ6_ONE = ((1, 0), (0, 0), (0, 0))


def _fq6_add(a, b):
    return (_fq2_add(a[0], b[0]), _fq2_add(a[1], b[1]), _fq2_add(a[2], b[2]))


def _fq6_sub(a, b):
    return (_fq2_sub(a[0], b[0]), _fq2_sub(a[1], b[1]), _fq2_sub(a[2], b[2]))


def _fq6_neg(a):
    return (_fq2_neg(a[0]), _fq2_neg(a[1]), _fq2_neg(a[2]))


def _fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = _fq2_mul(a0, b0)
    t1 = _fq2_mul(a1, b1)
    t2 = _fq2_mul(a2, b2)
    # c0 = t0 + xi * ((a1+a2)(b1+b2) - t1 - t2)
    c0 = _fq2_add(
        t0,
        _fq2_mul_xi(
            _fq2_sub(
                _fq2_sub(_fq2_mul(_fq2_add(a1, a2), _fq2_add(b1, b2)), t1), t2
            )
        ),
    )
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi * t2
    c1 = _fq2_add(
        _fq2_sub(_fq2_sub(_fq2_mul(_fq2_add(a0, a1), _fq2_add(b0, b1)), t0), t1),
        _fq2_mul_xi(t2),
    )
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = _fq2_add(
        _fq2_sub(_fq2_sub(_fq2_mul(_fq2_add(a0, a2), _fq2_add(b0, b2)), t0), t2),
        t1,
    )
    return (c0, c1, c2)


def _fq6_mul_v(a):
    # v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2
    return (_fq2_mul_xi(a[2]), a[0], a[1])


def _fq6_inv(a):
    a0, a1, a2 = a
    c0 = _fq2_sub(_fq2_sqr(a0), _fq2_mul_xi(_fq2_mul(a1, a2)))
    c1 = _fq2_sub(_fq2_mul_xi(_fq2_sqr(a2)), _fq2_mul(a0, a1))
    c2 = _fq2_sub(_fq2_sqr(a1), _fq2_mul(a0, a2))
    t = _fq2_add(
        _fq2_add(_fq2_mul_xi(_fq2_add(_fq2_mul(a2, c1), _fq2_mul(a1, c2))), _fq2_mul(a0, c0)),
        (0, 0),
    )
    tinv = _fq2_inv(t)
    return (_fq2_mul(c0, tinv), _fq2_mul(c1, tinv), _fq2_mul(c2, tinv))


_FQ12_ZERO = (_FQ6_ZERO, _FQ6_ZERO)
_FQ12_ONE = (_FQ6_ONE, _FQ6_ZERO)


def _fq12_add(a, b):
    return (_fq6_add(a[0], b[0]), _fq6_add(a[1], b[1]))


def _fq12_sub(a, b):
    return (_fq6_sub(a[0], b[0]), _fq6_sub(a[1], b[1]))


def _fq12_neg(a):
    return (_fq6_neg(a[0]), _fq6_neg(a[1]))


def _fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = _fq6_mul(a0, b0)
    t1 = _fq6_mul(a1, b1)
    c0 = _fq6_add(t0, _fq6_mul_v(t1))
    c1 = _fq6_sub(_fq6_sub(_fq6_mul(_fq6_add(a0, a1), _fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def _fq12_sqr(a):
    return _fq12_mul(a, a)


def _fq12_inv(a):
    a0, a1 = a
    t = _fq6_sub(_fq6_mul(a0, a0), _fq6_mul_v(_fq6_mul(a1, a1)))
    tinv = _fq6_inv(t)
    return (_fq6_mul(a0, tinv), _fq6_neg(_fq6_mul(a1, tinv)))


def _fq12_conj(a):
    # Conjugation = Frobenius^6 : a + b w  ->  a - b w
    return (a[0], _fq6_neg(a[1]))


def _fq12_pow(a, e):
    result = _FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = _fq12_mul(result, base)
        base = _fq12_sqr(base)
        e >>= 1
    return result


# Frobenius coefficients gamma_{1,j} = xi^(j*(p-1)/6) for j = 1..5 (Fq2 values).
_FROB_GAMMA1 = [_fq2_pow(_XI, j * (_P - 1) // 6) for j in range(1, 6)]


def _fq2_frob(a):
    return _fq2_conj(a)


def _fq6_frob(a):
    # (c0 + c1 v + c2 v^2)^p = c0^p + gamma_{1,2} c1^p v + gamma_{1,4} c2^p v^2
    return (
        _fq2_frob(a[0]),
        _fq2_mul(_fq2_frob(a[1]), _FROB_GAMMA1[1]),
        _fq2_mul(_fq2_frob(a[2]), _FROB_GAMMA1[3]),
    )


def _fq12_frob(a):
    # (a + b w)^p = a^p + gamma_{1,1} * b^p * w  (coefficient-wise on Fq6 of b)
    a0 = _fq6_frob(a[0])
    b = _fq6_frob(a[1])
    g = _FROB_GAMMA1[0]
    b = (_fq2_mul(b[0], g), _fq2_mul(b[1], g), _fq2_mul(b[2], g))
    return (a0, b)


class Fq12:
    """Thin object wrapper over tuple Fq12 arithmetic (pairing outputs)."""

    def __init__(self, t=_FQ12_ONE):
        self.t = t

    def __mul__(self, other):
        return Fq12(_fq12_mul(self.t, other.t))

    def __pow__(self, e):
        return Fq12(_fq12_pow(self.t, int(e)))

    def inv(self):
        return Fq12(_fq12_inv(self.t))

    def __eq__(self, other):
        return isinstance(other, Fq12) and self.t == other.t

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(("Fq12", self.t))

    @classmethod
    def one(cls):
        return cls(_FQ12_ONE)
