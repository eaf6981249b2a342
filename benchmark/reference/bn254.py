"""BN254: the scalar field Fr, the base field Fq and the group G1 on plain
Python integers (y^2 = x^3 + 3, generator (1, 2))."""

from __future__ import annotations

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
GENERATOR = (1, 2)
ROOT_BASE = 5  # 5 generates Fr*: the n-th roots of unity are its powers


def inv(x: int) -> int:
    return pow(x % R, -1, R)


def root_of_unity(n: int) -> int:
    if (R - 1) % n:
        raise ValueError(f"no {n}-th root of unity in Fr")
    return pow(ROOT_BASE, (R - 1) // n, R)


def powers(x: int, count: int) -> list[int]:
    out, acc = [], 1
    for _ in range(count):
        out.append(acc)
        acc = acc * x % R
    return out


def batch_inv(xs: list[int]) -> list[int]:
    """Inverses of nonzero elements of Fr with one modular inversion."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        acc = acc * x % R
    acc = pow(acc, -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * acc % R
        acc = acc * xs[i] % R
    return out


def dot(xs, ys) -> int:
    """sum(x * y) mod r, one reduction at the end."""
    return sum(map(int.__mul__, xs, ys)) % R


# -- G1 in Jacobian coordinates over Fq; None is the identity ---------------

def _double(p):
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    return X3, (E * (D - X3) - 8 * C) % Q, 2 * Y * Z % Q


def _add(p, r):
    if p is None:
        return r
    if r is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = r
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    H = (X2 * Z1Z1 - U1) % Q
    S = (Y2 * Z1 * Z1Z1 - S1) % Q
    if H == 0:
        return _double(p) if S == 0 else None
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (S * S - HHH - 2 * V) % Q
    return X3, (S * (V - X3) - S1 * HHH) % Q, Z1 * Z2 * H % Q


def _jac(p):
    return None if p is None else (p[0], p[1], 1)


def _affine(p):
    if p is None:
        return None
    X, Y, Z = p
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return X * zi2 % Q, Y * zi2 * zi % Q


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return 0 <= x < Q and 0 <= y < Q and (y * y - x * x * x - 3) % Q == 0


def lincomb(pairs) -> tuple | None:
    """sum(k_i * P_i) for affine points P_i (None = identity) and integer
    scalars k_i, as an affine point (None for the identity)."""
    acc = None
    for point, k in pairs:
        k %= R
        base = _jac(point)
        term = None
        for bit in bin(k)[2:] if k else "":
            term = _double(term)
            if bit == "1":
                term = _add(term, base)
        acc = _add(acc, term)
    return _affine(acc)


def mul_g(k: int) -> tuple | None:
    """k * G as an affine point."""
    return lincomb([(GENERATOR, k)])
