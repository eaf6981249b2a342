"""BN254 ate pairing (host, cold path — verifier only; 1-2 evals per verify).

Construction: G2 points are untwisted into the full Fq12 extension and the
Miller loop runs with generic affine line functions, followed by a structured
final exponentiation.  Mirrors the role py_ecc's `pairing` plays for the
reference (TESTING_verifier_DO_NOT_OPEN.py:148-160), implemented from the
standard BN ate-pairing construction.
"""

from __future__ import annotations

from .fields import (
    FQ_MOD,
    ATE_LOOP_COUNT,
    BN_X,
    Fq2,
    Fq12,
    _FQ6_ZERO,
    _FQ12_ONE,
    _fq12_add,
    _fq12_sub,
    _fq12_neg,
    _fq12_mul,
    _fq12_sqr,
    _fq12_inv,
    _fq12_conj,
    _fq12_pow,
    _fq12_frob,
)

_P = FQ_MOD


def _embed_fq(n: int):
    """Fq -> Fq12."""
    return (((int(n) % _P, 0), (0, 0), (0, 0)), _FQ6_ZERO)


def _untwist(q):
    """Map a twist point (x', y') in Fq2^2 to E(Fq12): (x' w^2, y' w^3).

    In tower coordinates w^2 = v, so x' w^2 = (0, x', 0) in Fq6 and
    y' w^3 = ((0, y', 0)) * w.
    """
    if q is None:
        return None
    x, y = q
    xt = (x.coeffs[0], x.coeffs[1])
    yt = (y.coeffs[0], y.coeffs[1])
    x12 = ((((0, 0)), xt, (0, 0)), _FQ6_ZERO)
    y12 = (_FQ6_ZERO, ((0, 0), yt, (0, 0)))
    return (x12, y12)


def _embed_g1(p):
    if p is None:
        return None
    return (_embed_fq(p[0].n), _embed_fq(p[1].n))


# -- generic affine point ops over Fq12 -------------------------------------

def _pt12_double(p):
    if p is None:
        return None
    x, y = p
    m = _fq12_mul(
        _fq12_mul(_fq12_sqr(x), _embed_fq(3)),
        _fq12_inv(_fq12_mul(y, _embed_fq(2))),
    )
    x3 = _fq12_sub(_fq12_sqr(m), _fq12_add(x, x))
    y3 = _fq12_sub(_fq12_mul(m, _fq12_sub(x, x3)), y)
    return (x3, y3)


def _pt12_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _pt12_double(p)
        return None
    m = _fq12_mul(_fq12_sub(y2, y1), _fq12_inv(_fq12_sub(x2, x1)))
    x3 = _fq12_sub(_fq12_sqr(m), _fq12_add(x1, x2))
    y3 = _fq12_sub(_fq12_mul(m, _fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _line(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all affine Fq12 points)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = _fq12_mul(_fq12_sub(y2, y1), _fq12_inv(_fq12_sub(x2, x1)))
        return _fq12_sub(_fq12_mul(m, _fq12_sub(xt, x1)), _fq12_sub(yt, y1))
    if y1 == y2:
        m = _fq12_mul(
            _fq12_mul(_fq12_sqr(x1), _embed_fq(3)),
            _fq12_inv(_fq12_mul(y1, _embed_fq(2))),
        )
        return _fq12_sub(_fq12_mul(m, _fq12_sub(xt, x1)), _fq12_sub(yt, y1))
    return _fq12_sub(xt, x1)


def _miller_loop(q12, p12):
    if q12 is None or p12 is None:
        return _FQ12_ONE
    r = q12
    f = _FQ12_ONE
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = _fq12_mul(_fq12_sqr(f), _line(r, r, p12))
        r = _pt12_double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = _fq12_mul(f, _line(r, q12, p12))
            r = _pt12_add(r, q12)
    # Frobenius correction steps of the ate pairing.
    q1 = (_fq12_frob(q12[0]), _fq12_frob(q12[1]))
    nq2 = (_fq12_frob(q1[0]), _fq12_neg(_fq12_frob(q1[1])))
    f = _fq12_mul(f, _line(r, q1, p12))
    r = _pt12_add(r, q1)
    f = _fq12_mul(f, _line(r, nq2, p12))
    return f


def _hard_part(f):
    """f^((p^4 - p^2 + 1) / r) for f in the cyclotomic subgroup (where an
    inverse is a conjugate).  The exponent is l0 + l1 p + l2 p^2 + p^3
    with l0 = -36x^3 - 30x^2 - 18x - 2, l1 = -36x^3 - 18x^2 - 12x + 1 and
    l2 = 6x^2 + 1 (x the BN parameter), so three powers by x, a few small
    ones and Frobenius maps compute it, where the plain power of the
    761-bit exponent takes ~760 squarings."""
    fx = _fq12_pow(f, BN_X)
    fx2 = _fq12_pow(fx, BN_X)
    fx3 = _fq12_pow(fx2, BN_X)
    fx3_36 = _fq12_pow(fx3, 36)
    f_l0 = _fq12_conj(_fq12_mul(
        _fq12_mul(fx3_36, _fq12_pow(fx2, 30)), _fq12_mul(_fq12_pow(fx, 18), _fq12_sqr(f))))
    f_l1 = _fq12_mul(_fq12_conj(_fq12_mul(
        _fq12_mul(fx3_36, _fq12_pow(fx2, 18)), _fq12_pow(fx, 12))), f)
    f_l2 = _fq12_mul(_fq12_pow(fx2, 6), f)
    f_p3 = _fq12_frob(_fq12_frob(_fq12_frob(f)))
    return _fq12_mul(_fq12_mul(f_l0, _fq12_frob(f_l1)),
                     _fq12_mul(_fq12_frob(_fq12_frob(f_l2)), f_p3))


def _final_exponentiate(f):
    # Easy part: f^((p^6 - 1)(p^2 + 1)).
    e1 = _fq12_mul(_fq12_conj(f), _fq12_inv(f))
    e2 = _fq12_mul(_fq12_frob(_fq12_frob(e1)), e1)
    # Hard part: ^((p^4 - p^2 + 1) / r).
    return _hard_part(e2)


def pairing(q, p) -> Fq12:
    """e(P, Q) with Q in G2 (Fq2 affine pair) and P in G1 (Fq affine pair).

    Argument order matches the ecosystem convention used by the reference:
    pairing(G2_point, G1_point).
    """
    return Fq12(_final_exponentiate(_miller_loop(_untwist(q), _embed_g1(p))))


def pairings_equal(q1, p1, q2, p2) -> bool:
    """pairing(q1, p1) == pairing(q2, p2), with ONE final exponentiation.

    The final exponentiation is a group homomorphism of Fq12*, so the two
    pairings are equal exactly when it maps the quotient of the two Miller
    loops' values to one; the verifiers' checks cost one final
    exponentiation instead of two, the same boolean."""
    f1 = _miller_loop(_untwist(q1), _embed_g1(p1))
    f2 = _miller_loop(_untwist(q2), _embed_g1(p2))
    return _final_exponentiate(_fq12_mul(f1, _fq12_inv(f2))) == _FQ12_ONE
