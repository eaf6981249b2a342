"""Field and point kernels: wrappers, launch counts and plain versions.

Counterpart of the JAX package's `ops/pallas_mont.py`.  Seven kernels live
here (CUDA C++ in `csrc/mont.cu`, over `csrc/field.cuh` and `csrc/g1.cuh`):

* K1 `mont_mul`     — elementwise Montgomery product in Fr or Fq;
* K2 `dif_butterfly` — one Stockham DIF stage (c0 + c1, (c0 - c1) * tw);
* K7 `jac_double_n` — n repeated Jacobian doublings over Fq;
* K8a `jac_add`     — complete Jacobian add on coordinate triples;
* K8a `jac_window_sum` — the sum of [16, W, n] window points over W in one
  launch (`Setup.generate`), the adds of a level-by-level halving;
* K8b `jac_madd`    — complete Jacobian + affine add;
* K9 `butterfly`    — the DIT butterfly (e + o * t, e - o * t) in Fr.

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


def check_operands(rows: int, *xs) -> None:
    """Validate kernel operands: CUDA, int32, `rows` limb rows, one device."""
    dev = xs[0].device
    for x in xs:
        if not x.is_cuda or x.device != dev:
            raise ValueError("kernel operands must all be on one CUDA device")
        if x.dtype != DTYPE or x.shape[0] != rows:
            raise ValueError(f"expected int32[{rows}, ...] limbs, got {x.dtype} {tuple(x.shape)}")


def check_limbs(rows: int, *xs) -> list:
    """Validate kernel operands (`check_operands`); returns them contiguous."""
    check_operands(rows, *xs)
    return [x.contiguous() for x in xs]


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
    """Coordinate tuple of [16, *batch] -> stacked [len*16, W].  Where the
    coordinates are consecutive 16-row blocks of one contiguous tensor (as
    `unstack_points` hands them out), those rows of the parent, no copy."""
    first = coords[0]
    step = NLIMBS * w
    if all(
        c.is_contiguous() and c.dtype == first.dtype and c.numel() == step
        and c.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
        and c.storage_offset() == first.storage_offset() + k * step
        for k, c in enumerate(coords)
    ):
        return first.as_strided((len(coords) * NLIMBS, w), (w, 1))
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


# ---------------------------------------------------------------------------
# K8a / K8b: complete adds on coordinate triples; K8a's window sum.
# ---------------------------------------------------------------------------

def jac_add_plain(p, q):
    arrs = torch.broadcast_tensors(*p, *q)
    return _kern_add(fq_plain, arrs[:3], arrs[3:])


def jac_madd_plain(p, q_aff):
    arrs = torch.broadcast_tensors(*p, *q_aff)
    return _kern_madd(fq_plain, arrs[:3], arrs[3:])


def point_operand(x, w: int):
    """(view, limb stride, column stride) of a broadcast [16, *batch]
    coordinate as the point kernels address it: limb k of element i at
    view[k * limb + i * col].  A view whose batch flattens to one axis of
    stride 1 (a contiguous tensor, or rows of one) or 0 (a broadcast from
    [16, 1]) goes as it is; any other operand is made contiguous, the only
    copy."""
    try:
        v = x.view(NLIMBS, w)
    except RuntimeError:  # the batch axes do not flatten without a copy
        v = None
    if v is None or (w > 1 and v.stride(1) not in (0, 1)):
        v = x.contiguous().view(NLIMBS, w)
    return v, v.stride(0), v.stride(1) if w > 1 else 0


def _point_launch(kernel: str, entry: str, arrs):
    """Launch on the broadcast coordinates of p (3) and q (2 or 3), each
    handed over as a view (`point_operand`); unstack the [48, W] output."""
    check_operands(NLIMBS, *arrs)
    shape_tail = arrs[0].shape[1:]
    w = _width(arrs[0])
    ops = [point_operand(x, w) for x in arrs]
    strides = (ctypes.c_longlong * (2 * len(ops)))(*(s for _, *ls in ops for s in ls))
    out = torch.empty((3 * NLIMBS, w), dtype=DTYPE, device=arrs[0].device)
    rc = fn(entry)(
        *(v.data_ptr() for v, _, _ in ops), strides, out.data_ptr(), w,
        field_consts("fq"), stream_ptr(out.device),
    )
    count_launch(kernel)
    check(rc, entry)
    return unstack_points(out, shape_tail)


def jac_add(p, q):
    """Complete Jacobian add on [16, *batch] coordinate triples
    (broadcasting); identity, p == q and p == -q handled."""
    arrs = torch.broadcast_tensors(*p, *q)
    if not any(x.is_cuda for x in arrs):
        return jac_add_plain(p, q)
    return _point_launch("K8a add", "k8a_jac_add", arrs)


def jac_window_sum_plain(p):
    """Sum window-major Jacobian points p = (X, Y, Z), each [16, W, n], over
    W (a power of two) with the plain add, halving level by level: each
    level adds windows (2j, 2j + 1), the JAX package's `curve.jac_fold_sum`
    order."""
    X, Y, Z = p
    while X.shape[1] > 1:
        X, Y, Z = jac_add_plain(
            (X[:, 0::2], Y[:, 0::2], Z[:, 0::2]), (X[:, 1::2], Y[:, 1::2], Z[:, 1::2])
        )
    return (X[:, 0], Y[:, 0], Z[:, 0])


def jac_window_sum(p):
    """Sum window-major Jacobian points p = (X, Y, Z), each [16, W, n], over
    the window axis W (a power of two, at most 32 on the card): [16, n]
    coordinates.  The same adds in the same pairing as
    `jac_window_sum_plain`, so the same raw limbs, in ONE launch."""
    if not any(c.is_cuda for c in p):
        return jac_window_sum_plain(p)
    x, y, z = check_limbs(NLIMBS, *p)
    if x.ndim != 3 or not x.shape == y.shape == z.shape:
        raise ValueError(f"jac_window_sum: expected three [16, W, n], got {tuple(x.shape)}")
    windows, n = x.shape[1], x.shape[2]
    if windows < 2 or windows > 32 or windows & (windows - 1):
        raise ValueError(f"jac_window_sum: W = {windows} is not a power of two in [2, 32]")
    out = torch.empty((3 * NLIMBS, n), dtype=DTYPE, device=x.device)
    rc = fn("k8a_window_sum")(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(), n, windows,
        field_consts("fq"), stream_ptr(x.device),
    )
    count_launch("K8a")
    check(rc, "k8a_window_sum")
    return unstack_points(out, (n,))


def jac_madd(p, q_aff):
    """Complete Jacobian + affine add; q_aff = (x, y) Montgomery limbs, never
    the identity."""
    arrs = torch.broadcast_tensors(*p, *q_aff)
    if not any(x.is_cuda for x in arrs):
        return jac_madd_plain(p, q_aff)
    return _point_launch("K8b", "k8b_jac_madd", arrs)


# ---------------------------------------------------------------------------
# K9: DIT butterfly.
# ---------------------------------------------------------------------------

def butterfly_plain(even, odd, tw):
    even, odd, tw = torch.broadcast_tensors(even, odd, tw)
    k = fr_plain
    prod = k.mul(odd, tw)
    return k.add(even, prod), k.sub(even, prod)


def butterfly(even, odd, tw):
    """(e, o, t) -> (e + o * t, e - o * t) in Fr over [16, *batch]
    (tw broadcastable)."""
    if not (even.is_cuda or odd.is_cuda or tw.is_cuda):
        return butterfly_plain(even, odd, tw)
    even, odd, tw = check_limbs(NLIMBS, *torch.broadcast_tensors(even, odd, tw))
    lo = torch.empty_like(even)
    hi = torch.empty_like(even)
    rc = fn("k9_butterfly")(
        even.data_ptr(), odd.data_ptr(), tw.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        _width(even), field_consts("fr"), stream_ptr(even.device),
    )
    count_launch("K9")
    check(rc, "k9_butterfly")
    return lo, hi
