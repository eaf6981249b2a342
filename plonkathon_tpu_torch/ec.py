"""Host-side BN254 curve groups G1 (over Fq) and G2 (over Fq2).

Affine representation: a point is a `(x, y)` tuple of field elements, and the
identity is `None` (matching the reference ecosystem's convention so golden
JSON fixtures decode identically; cf. reference utils.py:10-22).

This module is a cold path: it backs the verifier (~20-point MSMs) and acts as
the correctness oracle for the device MSM in `plonkathon_tpu_torch.ops.curve`.
Functional parity: reference curve.py:30-111 (ec_mul / ec_lincomb).
"""

from __future__ import annotations

from .fields import Fq, Fq2, Fr, FQ_MOD, FR_MOD

# Curve: y^2 = x^3 + 3 over Fq; twist: y^2 = x^3 + 3/(9+u) over Fq2.
B1 = Fq(3)
B2 = Fq2([3, 0]) / Fq2([9, 1])

G1 = (Fq(1), Fq(2))
G2 = (
    Fq2(
        [
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ]
    ),
    Fq2(
        [
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ]
    ),
)

# Identity elements (None, matching py_ecc's Z1/Z2 convention).
Z1 = None
Z2 = None


def is_on_curve(pt, b) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b


def pt_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def pt_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return pt_double(p)
        return None  # p == -q
    slope = (y2 - y1) / (x2 - x1)
    x3 = slope * slope - x1 - x2
    y3 = slope * (x1 - x3) - y1
    return (x3, y3)


def pt_double(p):
    if p is None:
        return None
    x, y = p
    slope = (x * x * 3) / (y * 2)
    x3 = slope * slope - x - x
    y3 = slope * (x - x3) - y
    return (x3, y3)


def pt_mul(pt, k: int):
    """Scalar multiplication: on G1 the Jacobian `msm` of one term, on G2
    double-and-add, MSB first."""
    k = int(k) % FR_MOD
    if k == 0 or pt is None:
        return None
    if isinstance(pt[0], Fq):
        return msm([(pt, k)])
    result = None
    for bit in bin(k)[2:]:
        result = pt_double(result)
        if bit == "1":
            result = pt_add(result, pt)
    return result


def ec_mul(pt, coeff):
    """Reference-compatible alias (curve.py:30-33): coeff reduced mod r."""
    if hasattr(coeff, "n"):
        coeff = coeff.n
    return pt_mul(pt, coeff % FR_MOD)


def _jac_double(p):
    """Jacobian doubling on G1 over ints mod q (a = 0; Y != 0 on G1, whose
    order is prime)."""
    X, Y, Z = p
    q = FQ_MOD
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    X3 = (E * E - 2 * D) % q
    return X3, (E * (D - X3) - 8 * C) % q, 2 * Y * Z % q


def _jac_add(p, r):
    """Jacobian add on G1 over ints mod q; None is the identity."""
    if p is None:
        return r
    if r is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = r
    q = FQ_MOD
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    S1 = Y1 * Z2 * Z2Z2 % q
    H = (X2 * Z1Z1 - U1) % q
    R = (Y2 * Z1 * Z1Z1 - S1) % q
    if H == 0:
        return _jac_double(p) if R == 0 else None
    HH = H * H % q
    HHH = H * HH % q
    V = U1 * HH % q
    X3 = (R * R - HHH - 2 * V) % q
    return X3, (R * (V - X3) - S1 * HHH) % q, Z1 * Z2 * H % q


def _jac_to_affine(p):
    """Jacobian G1 point over ints (or None) -> affine Fq pair (or None):
    the G1 Pippenger's one inversion, where the affine adds take one an
    add."""
    if p is None:
        return None
    X, Y, Z = p
    zi = pow(Z, -1, FQ_MOD)
    zi2 = zi * zi % FQ_MOD
    return Fq(X * zi2), Fq(Y * zi2 * zi)


def msm(pairs):
    """Multi-scalar multiplication sum(coeff_i * point_i) on the host.

    Windowed Pippenger (4-bit windows).  Used by the verifier (small inputs)
    and as the oracle for the device MSM.  Replaces reference curve.py:38-111
    with a standard bucket method rather than the multicomb scheme.  G1
    sums run in Jacobian coordinates over ints; G2 sums in affine ones
    over Fq2.
    """
    window = 4
    nbuckets = 1 << window
    prepared = []
    for pt, coeff in pairs:
        c = int(coeff.n if hasattr(coeff, "n") else coeff) % FR_MOD
        if pt is not None and c != 0:
            prepared.append((pt, c))
    if not prepared:
        return None
    if isinstance(prepared[0][0][0], Fq):
        add, double, finish = _jac_add, _jac_double, _jac_to_affine
        prepared = [((x.n, y.n, 1), c) for (x, y), c in prepared]
    else:
        add, double, finish = pt_add, pt_double, lambda p: p
    nwindows = (FR_MOD.bit_length() + window - 1) // window
    total = None
    for w in range(nwindows - 1, -1, -1):
        if total is not None:
            for _ in range(window):
                total = double(total)
        buckets = [None] * nbuckets
        shift = w * window
        for pt, c in prepared:
            digit = (c >> shift) & (nbuckets - 1)
            if digit:
                buckets[digit] = add(buckets[digit], pt)
        running = None
        acc = None
        for d in range(nbuckets - 1, 0, -1):
            running = add(running, buckets[d])
            acc = add(acc, running)
        total = add(total, acc)
    return finish(total)


def ec_lincomb(pairs):
    """Reference-compatible alias for `msm` (curve.py:38-49)."""
    return msm(pairs)
