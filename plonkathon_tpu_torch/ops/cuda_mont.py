"""Field and point kernels: wrappers, launch counts and plain versions.

Counterpart of the JAX package's `ops/pallas_mont.py`.  Three kernels live
here (CUDA C++ in `csrc/mont.cu`, over `csrc/field.cuh` and `csrc/g1.cuh`):

* K1 `mont_mul`     — elementwise Montgomery product in Fr or Fq;
* K2 `dif_butterfly` — one Stockham DIF stage (c0 + c1, (c0 - c1) * tw);
* K7 `jac_double_n` — n repeated Jacobian doublings over Fq.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain torch version only for CPU tensors; there is no fallback from
the card to the plain version.  The plain point formulas `_kern_double`,
`_kern_add` and `_kern_madd` are op for op those of pallas_mont.py, on any
`FieldOps` (the plain versions use the `plain=True` field, so they never
launch a kernel themselves).
"""

from __future__ import annotations

import ctypes

import torch

from .limbs import NLIMBS, DTYPE, FIELDS, PLAIN_FIELDS, fq_plain, fr_plain
from .cuda_lib import fn, check, stream_ptr, count_launch

_CONSTS: dict = {}


def field_consts(field: str):
    """FieldConst (csrc/field.cuh) for `field` as a host uint32[25] buffer:
    p, 2p and the Montgomery one as 8 x 32-bit words, then -p^-1 mod 2^32."""
    buf = _CONSTS.get(field)
    if buf is None:
        ops = FIELDS[field]
        words = []
        for limbs in (ops.P, ops.P2, ops.ONE_MONT):
            words += [int(limbs[2 * k]) | (int(limbs[2 * k + 1]) << 16) for k in range(8)]
        words.append((-pow(ops.modulus, -1, 1 << 32)) % (1 << 32))
        buf = (ctypes.c_uint32 * 25)(*words)
        _CONSTS[field] = buf
    return buf


def check_limbs(rows: int, *xs) -> list:
    """Validate kernel operands: CUDA, int32, `rows` limb rows, one device.
    Returns them contiguous."""
    dev = xs[0].device
    out = []
    for x in xs:
        if not x.is_cuda or x.device != dev:
            raise ValueError("kernel operands must all be on one CUDA device")
        if x.dtype != DTYPE or x.shape[0] != rows:
            raise ValueError(f"expected int32[{rows}, ...] limbs, got {x.dtype} {tuple(x.shape)}")
        out.append(x.contiguous())
    return out


def _width(x) -> int:
    return x.numel() // x.shape[0]


# ---------------------------------------------------------------------------
# K1: Montgomery product.
# ---------------------------------------------------------------------------

def mont_mul_plain(field: str, a, b):
    return PLAIN_FIELDS[field].mul_plain(a, b)


def mont_mul(field: str, a, b):
    """Elementwise Montgomery product on [16, *batch] limbs, broadcasting
    like `jnp.broadcast_arrays` (e.g. a [16, 1] scalar against [16, n])."""
    if not (a.is_cuda or b.is_cuda):
        return mont_mul_plain(field, a, b)
    a, b = check_limbs(NLIMBS, *torch.broadcast_tensors(a, b))
    out = torch.empty_like(a)
    rc = fn("k1_mont_mul")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), _width(a),
        field_consts(field), stream_ptr(a.device),
    )
    count_launch(f"K1 {field}")
    check(rc, "k1_mont_mul")
    return out


# ---------------------------------------------------------------------------
# K2: Stockham DIF butterfly stage.
# ---------------------------------------------------------------------------

def dif_butterfly_plain(c0, c1, tw):
    c0, c1, tw = torch.broadcast_tensors(c0, c1, tw)
    k = fr_plain
    return k.add(c0, c1), k.mul(k.sub(c0, c1), tw)


def dif_butterfly(c0, c1, tw):
    """(c0, c1, tw) -> (c0 + c1, (c0 - c1) * tw) in Fr over [16, *batch]
    (tw broadcastable)."""
    if not (c0.is_cuda or c1.is_cuda or tw.is_cuda):
        return dif_butterfly_plain(c0, c1, tw)
    c0, c1, tw = check_limbs(NLIMBS, *torch.broadcast_tensors(c0, c1, tw))
    s = torch.empty_like(c0)
    d = torch.empty_like(c0)
    rc = fn("k2_dif_butterfly")(
        c0.data_ptr(), c1.data_ptr(), tw.data_ptr(), s.data_ptr(), d.data_ptr(),
        _width(c0), field_consts("fr"), stream_ptr(c0.device),
    )
    count_launch("K2")
    check(rc, "k2_dif_butterfly")
    return s, d


# ---------------------------------------------------------------------------
# Plain G1 point formulas (a = 0, identity = Z == 0), op for op the
# pallas_mont kernel bodies.
# ---------------------------------------------------------------------------

def _kern_double(k, p):
    X, Y, Z = p
    A = k.sqr(X)
    B = k.sqr(Y)
    C = k.sqr(B)
    D = k.sub(k.sqr(k.add(X, B)), k.add(A, C))
    D = k.add(D, D)
    E = k.add(k.add(A, A), A)
    F = k.sqr(E)
    X3 = k.sub(F, k.add(D, D))
    C2 = k.add(C, C)
    C8 = k.add(k.add(C2, C2), k.add(C2, C2))
    Y3 = k.sub(k.mul(E, k.sub(D, X3)), C8)
    Z3 = k.mul(k.add(Y, Y), Z)
    return X3, Y3, Z3


def _select_double(k, same, p, r):
    """Where `same`, replace r by the doubling of p.  The kernel bodies
    compute the doubling on every lane and select it; the formulas here
    compute it only when some lane selects it, which is the same function
    at a third less work when no lane does (the common case)."""
    d = _kern_double(k, p)
    return tuple(k.select(same, dc, rc) for dc, rc in zip(d, r))


def _kern_add(k, p, q):
    """Complete Jacobian + Jacobian (identity/equal/inverse handled)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = k.sqr(Z1)
    Z2Z2 = k.sqr(Z2)
    U1 = k.mul(X1, Z2Z2)
    U2 = k.mul(X2, Z1Z1)
    S1 = k.mul(Y1, k.mul(Z2, Z2Z2))
    S2 = k.mul(Y2, k.mul(Z1, Z1Z1))
    H = k.sub(U2, U1)
    R = k.sub(S2, S1)
    HH = k.sqr(H)
    HHH = k.mul(H, HH)
    V = k.mul(U1, HH)
    X3 = k.sub(k.sub(k.sqr(R), HHH), k.add(V, V))
    Y3 = k.sub(k.mul(R, k.sub(V, X3)), k.mul(S1, HHH))
    Z3 = k.mul(k.mul(Z1, Z2), H)

    p_inf = k.is_zero(Z1)
    q_inf = k.is_zero(Z2)
    either = p_inf | q_inf
    h_zero = k.is_zero(H) & ~either
    same = h_zero & k.is_zero(R)
    cancel = h_zero & ~k.is_zero(R)

    if bool(same.any()):
        X3, Y3, Z3 = _select_double(k, same, p, (X3, Y3, Z3))
    zero = torch.zeros_like(Z3)
    Z3 = k.select(cancel, zero, Z3)
    X3 = k.select(q_inf, X1, k.select(p_inf, X2, X3))
    Y3 = k.select(q_inf, Y1, k.select(p_inf, Y2, Y3))
    Z3 = k.select(q_inf, Z1, k.select(p_inf, Z2, Z3))
    return X3, Y3, Z3


def _kern_madd(k, p, q_aff):
    """Complete Jacobian + affine (q never infinity; p may be; p==q doubles)."""
    X1, Y1, Z1 = p
    X2, Y2 = q_aff
    Z1Z1 = k.sqr(Z1)
    U2 = k.mul(X2, Z1Z1)
    S2 = k.mul(Y2, k.mul(Z1, Z1Z1))
    H = k.sub(U2, X1)
    R = k.sub(S2, Y1)
    HH = k.sqr(H)
    HHH = k.mul(H, HH)
    V = k.mul(X1, HH)
    X3 = k.sub(k.sub(k.sqr(R), HHH), k.add(V, V))
    Y3 = k.sub(k.mul(R, k.sub(V, X3)), k.mul(Y1, HHH))
    Z3 = k.mul(Z1, H)

    p_inf = k.is_zero(Z1)
    h_zero = k.is_zero(H) & ~p_inf
    same = h_zero & k.is_zero(R)
    cancel = h_zero & ~k.is_zero(R)

    if bool(same.any()):
        X3, Y3, Z3 = _select_double(k, same, p, (X3, Y3, Z3))
    one = k.full("ONE_MONT", Z3)
    zero = torch.zeros_like(Z3)
    Z3 = k.select(cancel, zero, Z3)
    X3 = k.select(p_inf, X2, X3)
    Y3 = k.select(p_inf, Y2, Y3)
    Z3 = k.select(p_inf, one, Z3)
    return X3, Y3, Z3


# ---------------------------------------------------------------------------
# K7: repeated doubling.
# ---------------------------------------------------------------------------

def stack_points(coords, w: int):
    """Coordinate tuple of [16, *batch] -> stacked [len*16, W]."""
    return torch.cat([c.reshape(NLIMBS, w) for c in coords], dim=0)


def unstack_points(arr, shape_tail):
    return tuple(
        arr[i * NLIMBS : (i + 1) * NLIMBS].reshape((NLIMBS,) + tuple(shape_tail))
        for i in range(arr.shape[0] // NLIMBS)
    )


def jac_double_n_plain(p, n_times: int = 1):
    for _ in range(n_times):
        p = _kern_double(fq_plain, p)
    return p


def jac_double_n(p, n_times: int = 1):
    """n_times doublings of Jacobian points ([16, *batch] triples) in ONE
    launch; the same function as n_times applications of `_kern_double`."""
    if not p[0].is_cuda:
        return jac_double_n_plain(p, n_times)
    shape_tail = p[0].shape[1:]
    w = _width(p[0])
    (a,) = check_limbs(3 * NLIMBS, stack_points(p, w))
    out = torch.empty_like(a)
    rc = fn("k7_jac_double_n")(
        a.data_ptr(), out.data_ptr(), w, int(n_times), field_consts("fq"),
        stream_ptr(a.device),
    )
    count_launch("K7")
    check(rc, "k7_jac_double_n")
    return unstack_points(out, shape_tail)
