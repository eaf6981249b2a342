"""Batched 256-bit prime-field arithmetic on torch tensors.

Same wire format as the JAX package's `ops/limbs.py`:

* An element is 16 little-endian limbs of 16 bits each.  They are stored in
  `int32` (the same bytes as the JAX package's `uint32`, and torch's CPU
  backend has no uint32 `+`, `>>` or `<`).
* Layout is limb-major: tensors are `int32[16, *batch]`; a scalar is
  `int32[16]`.
* Hot-path values live in Montgomery form (R = 2^256) in the lazy domain
  [0, 2p): `mul` is a Montgomery product whose output stays < 2p without a
  final subtraction; `add` subtracts 2p once when the sum is >= 2p; `sub`
  adds 2p on a borrow.  Every operation is therefore a unique function of
  its inputs' raw limbs, whatever the word size an implementation uses, so
  the CUDA kernels and the plain versions here agree limb for limb.

`mul` is the dispatch point for the Montgomery-product kernel
(`ops/cuda_mont.py`): a CUDA tensor launches it at any width, a CPU tensor
takes the plain version.  Everything else here is plain torch on either
device; plain arithmetic widens to int64 (and to float64 for wide
products), where 16x16-bit products and their column sums are exact.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
NLIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NLIMBS  # 256
DTYPE = torch.int32


# ---------------------------------------------------------------------------
# Host encode / decode (numpy int32 limb arrays).
# ---------------------------------------------------------------------------

def encode_int(n: int) -> np.ndarray:
    """Python int -> int32[16] little-endian 16-bit limbs."""
    return np.array(
        [(n >> (LIMB_BITS * k)) & LIMB_MASK for k in range(NLIMBS)], dtype=np.int32
    )


def encode_ints(ns) -> np.ndarray:
    """list[int] -> int32[16, len(ns)] (one `int.to_bytes` per element)."""
    if not isinstance(ns, (list, tuple)):
        ns = list(ns)
    buf = b"".join(int(n).to_bytes(32, "little") for n in ns)
    a = np.frombuffer(buf, dtype="<u2").reshape(len(ns), NLIMBS)
    return np.ascontiguousarray(a.T).astype(np.int32)


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr)


def decode_int(arr) -> int:
    a = _host(arr).astype(np.int64).reshape(NLIMBS)
    return sum(int(a[k]) << (LIMB_BITS * k) for k in range(NLIMBS))


def decode_ints(arr) -> list[int]:
    """int32[16, *batch] -> flat list of ints (bytes-based)."""
    a = _host(arr)
    assert a.shape[0] == NLIMBS
    flat = np.ascontiguousarray(a.reshape(NLIMBS, -1).T).astype("<u2")
    buf = flat.tobytes()
    return [
        int.from_bytes(buf[32 * j : 32 * j + 32], "little")
        for j in range(flat.shape[0])
    ]


def to_device(arr, device) -> torch.Tensor:
    """Host int32 limb array -> tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  There is no silent CPU fallback: asking for CUDA without a
    card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the host"
        )
    return dev


# ---------------------------------------------------------------------------
# Plain carry / borrow machinery (int64 limb rows).
#
# Every function is exact integer arithmetic, so the limbs it returns are
# the only ones a correct implementation can return, and two of them may
# be chosen by cost.  On a card the lazy add / sub / canon resolve their
# carries with a Kogge-Stone prefix: a fixed number of ops and no read
# back to the host, so the proof's rounds queue without a stall.  On the
# CPU, where each torch op costs microseconds of dispatch whatever its
# width, they resolve them by split-carry passes until none is left
# (`_normalize`), in a third of the ops.
# ---------------------------------------------------------------------------

def _shift_up(x, s: int):
    """Move limb rows toward higher indices by s (zeros enter at row 0)."""
    return torch.cat([torch.zeros_like(x[:s]), x[:-s]], dim=0)


def _prefix(g, p):
    """Kogge-Stone generate/propagate prefix over the limb axis."""
    step = 1
    while step < g.shape[0]:
        g = g | (p & _shift_up(g, step))
        p = p & _shift_up(p, step)
        step *= 2
    return g


def _carry1(s):
    """Limb sums < 2^17 (at most one carry each) -> 16-bit limbs mod 2^(16K)."""
    g = _prefix((s >> LIMB_BITS) != 0, (s & LIMB_MASK) == LIMB_MASK)
    return (s + _shift_up(g, 1).to(s.dtype)) & LIMB_MASK


def _sub_limbs(a, b):
    """(a - b) mod 2^(16K) and the borrow out; canonical 16-bit inputs."""
    d = a - b
    g = _prefix(d < 0, d == 0)
    return (d - _shift_up(g, 1).to(d.dtype)) & LIMB_MASK, g[-1]


_SKEW_MAX = 64  # widest `_redc` whose products are outer products (`_columns`)
_CHUNK = 1 << 20  # lanes per `_redc` call (its int64 temporaries: ~1 KiB a lane)


def _normalize(t, passes: int = 1, top: bool = False):
    """Int64 limb rows of any sign -> 16-bit digits of the same integer mod
    2^(16 rows), in place; with `top`, (digits, the carry out of the top
    row, None for none).

    Split-carry passes: each moves every row's bits above 16 one row up.
    Rows below 2^(16 k) settle in about k passes; a carry rippling through
    0xFFFF digits takes one pass a digit, which is rare in random digits,
    so the loop runs until no row carries.  The first `passes` run without
    that check."""
    out = None
    while True:
        c = torch.bitwise_right_shift(t, LIMB_BITS)
        if passes <= 0 and not c.count_nonzero().item():
            return (t, out) if top else t
        passes -= 1
        t.bitwise_and_(LIMB_MASK)
        t[1:].add_(c[:-1])
        if top:
            out = c[-1] if out is None else out + c[-1]


def _columns(a, b, buf):
    """Schoolbook product columns sum_{i+j=k} a_i b_j of limb rows a, b
    [16, w] (either may be [16, 1]) -> int64 [32, w] (row 31 is zero), in
    three ops: the outer product is written into `buf`, a zeroed int64
    [16, 32, w], through the view whose row i starts i columns in (stride
    33 w over the rows), and one sum over the 16 rows adds each column.
    The other cells stay zero, so `buf` serves the next product too."""
    w = buf.shape[-1]
    skew = buf.as_strided((NLIMBS, NLIMBS, w), ((2 * NLIMBS + 1) * w, w, 1))
    torch.mul(a.to(torch.int64)[:, None], b.to(torch.int64)[None, :], out=skew)
    return buf.sum(0)


def _columns_f64(a, b):
    """The same columns as float64, in 16 row-shifted `addcmul_`s on a
    [32, w] accumulator: vectorized where int64 products are not, and
    exact, every partial sum an integer below 2^36."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    t = torch.zeros((2 * NLIMBS, a.shape[1]), dtype=torch.float64, device=a.device)
    for i in range(NLIMBS):
        t[i : i + NLIMBS].addcmul_(a[i], b)
    return t


def _toeplitz(digits, rows: int, device) -> torch.Tensor:
    """float64 [rows, 16] matrix M[k, i] = digits[k - i] (0 outside 0..15):
    M @ x holds the product columns of the constant and x."""
    m = np.zeros((rows, NLIMBS))
    for i in range(NLIMBS):
        for k in range(i, min(rows, i + NLIMBS)):
            m[k, i] = int(digits[k - i])
    return torch.tensor(m, dtype=torch.float64, device=device)


def _col(vals, ndim: int, device) -> torch.Tensor:
    """int64 [16, 1, ...] constant column broadcasting against ndim-dim limbs."""
    t = torch.tensor([int(v) for v in vals], dtype=torch.int64, device=device)
    return t.reshape((NLIMBS,) + (1,) * (ndim - 1))


class FieldOps:
    """Modular arithmetic over a fixed prime on limb-major int32 tensors.

    `plain=True` makes `mul` take the plain torch Montgomery product on
    every device; the CUDA kernels' plain versions are built on such an
    instance, so that comparing a kernel with its plain version on the card
    never launches a kernel inside the plain version.
    """

    def __init__(self, modulus: int, name: str, plain: bool = False):
        assert modulus < (1 << (R_BITS - 2)), "lazy domain needs 4p < 2^256"
        self.modulus = modulus
        self.name = name
        self.plain = plain
        r = 1 << R_BITS
        self.P = encode_int(modulus)
        self.P2 = encode_int(2 * modulus)
        self.NPRIME = encode_int((-pow(modulus, -1, r)) % r)  # -p^-1 mod 2^256
        self.r_mod_p = r % modulus
        self.R2 = encode_int(pow(r, 2, modulus))
        self.ONE_RAW = encode_int(1)
        self.ONE_MONT = encode_int(self.r_mod_p)
        self.ZERO = encode_int(0)
        self._inv_bits = [int(b) for b in bin(modulus - 2)[2:]]  # MSB first
        self._n0 = int(self.NPRIME[0])  # -p^-1 mod 2^16
        self._cache: dict = {}

    def const(self, name: str, device, ndim: int = 1) -> torch.Tensor:
        """Limb constant (e.g. "ONE_MONT") as int32 [16, 1, ...] on device."""
        key = (name, str(device), ndim)
        t = self._cache.get(key)
        if t is None:
            t = to_device(getattr(self, name), device).reshape(
                (NLIMBS,) + (1,) * (ndim - 1)
            )
            self._cache[key] = t
        return t

    def _c64(self, name: str, like, pair: bool = False) -> torch.Tensor:
        """int64 column of a constant, [16, 1, ...] against `like`; with
        `pair`, [16, 2, 1, ...]: zero beside it ("M2" is -2p)."""
        key = (name, str(like.device), like.ndim, pair)
        t = self._cache.get(key)
        if t is None:
            if name == "M2":
                t = -_col(self.P2, like.ndim, like.device)
            else:
                t = _col(getattr(self, name), like.ndim, like.device)
            if pair:
                t = torch.stack([torch.zeros_like(t), t], 1)
            self._cache[key] = t
        return t

    def scalar(self, n: int, device) -> torch.Tensor:
        """Host int -> int32[16] Montgomery limbs on device."""
        return to_device(self.to_mont_host(n), device)

    def full(self, name: str, like) -> torch.Tensor:
        """Constant broadcast to `like`'s shape (materialized)."""
        return self.const(name, like.device, like.ndim).expand(like.shape).contiguous()

    # -- host conversion helpers (Montgomery domain) ----------------------
    def to_mont_host(self, n: int) -> np.ndarray:
        return encode_int((int(n) % self.modulus) * self.r_mod_p % self.modulus)

    def to_mont_host_many(self, ns) -> np.ndarray:
        rp, p = self.r_mod_p, self.modulus
        return encode_ints([(int(n) % p) * rp % p for n in ns])

    def from_mont_host(self, arr) -> int:
        rinv = pow(self.r_mod_p, -1, self.modulus)
        return decode_int(arr) * rinv % self.modulus

    def from_mont_host_many(self, arr) -> list[int]:
        rinv = pow(self.r_mod_p, -1, self.modulus)
        p = self.modulus
        return [v * rinv % p for v in decode_ints(arr)]

    # -- lazy-domain add / sub / canon -----------------------------------
    def _cond_sub(self, s, name: str):
        """Subtract the constant `name` once if s >= it (int64 in/out)."""
        d, borrow = _sub_limbs(s, self._c64(name, s))
        return torch.where(borrow[None], s, d)

    def _pair(self, x, name: str):
        """[16, 2, *batch] int64: x beside x + c (`name` "P2") or x - c
        ("M2": -2p), normalized together; their carries out of the top."""
        return _normalize(x[:, None] + self._c64(name, x, pair=True), top=True)

    def canon(self, a):
        """Lazy [0, 2p) -> canonical [0, p): a - p unless that borrows."""
        a = a.to(torch.int64)
        if a.device.type != "cpu":
            return self._cond_sub(a, "P").to(DTYPE)
        d, top = _normalize(a - self._c64("P", a), passes=0, top=True)
        return (d if top is None else torch.where(top[None] < 0, a, d)).to(DTYPE)

    def add(self, a, b):
        """s = a + b mod 2^256, less 2p if s >= 2p.  On the CPU s and s - 2p
        are normalized side by side, and s - 2p borrowed past s's own carry
        out exactly when s < 2p."""
        s = a.to(torch.int64) + b
        if s.device.type != "cpu":
            return self._cond_sub(_carry1(s), "P2").to(DTYPE)
        y, top = self._pair(s, "M2")
        if top is None:
            return y[:, 1].to(DTYPE)
        return torch.where((top[1] < top[0])[None], y[:, 0], y[:, 1]).to(DTYPE)

    def sub(self, a, b):
        """a - b, plus 2p where it borrows (mod 2^256).  On the CPU a - b
        and a - b + 2p are normalized side by side."""
        if a.device.type != "cpu" or b.device.type != "cpu":
            a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
            d, borrow = _sub_limbs(a, b)
            d = d + torch.where(borrow[None], self._c64("P2", d), 0)
            return _carry1(d).to(DTYPE)
        y, top = self._pair(a.to(torch.int64) - b, "P2")
        if top is None:
            return y[:, 0].to(DTYPE)
        return torch.where((top[0] < 0)[None], y[:, 1], y[:, 0]).to(DTYPE)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    # -- multiplication ---------------------------------------------------
    def mul_plain(self, a, b):
        """Montgomery product a*b*2^-256 mod p, lazy [0, 2p) in and out.

        The result is the one integer (a*b + m*p) / 2^256 with m < 2^256
        and a*b + m*p = 0 mod 2^256, so it is the same integer every
        Montgomery implementation gives.  Here it is computed in a few wide
        int64 and float64 ops (`_redc`), a chunk of lanes at a time."""
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        a = a.reshape(NLIMBS, -1)
        b = b.reshape(NLIMBS, -1)
        w = a.shape[1]
        if w <= _CHUNK:
            return self._redc(a, b).reshape(shape)
        out = torch.empty((NLIMBS, w), dtype=DTYPE, device=a.device)
        for s in range(0, w, _CHUNK):
            out[:, s : s + _CHUNK] = self._redc(a[:, s : s + _CHUNK], b[:, s : s + _CHUNK])
        return out.reshape(shape)

    def _redc(self, a, b):
        """a*b*2^-256 on int32 limb rows [16, w], in int64 and float64.

        T: the product columns of a*b, each < 2^36.  m = (T mod 2^256) *
        (-p^-1) mod 2^256, from T's low columns as they are (each column
        of that product < 2^56), and U = T + m*p: columns < 2^37, whose
        low 16 hold a multiple of 2^256.  Those low digits are all zero, so
        normalizing them would ripple one pass a row; their carry into
        column 16 is read from columns 15 and 14 alone instead: with X =
        U_15 * 2^16 + U_14, the low columns are c * 2^256 = (X + e) * 2^224
        for an integer e in [0, 2^37 / (2^16 - 1)), so c = (X + 2^22) >> 32.

        Narrow (op count first), the products in int64 (`_columns`).  Wide
        (memory traffic first), a*b in float64 (`_columns_f64`) and the two
        products by a constant as float64 matmuls with its Toeplitz
        matrix, exact where every partial sum is below 2^53: -p^-1's digits
        split into their 8-bit halves against T (sums < 2^48), and p's
        against m's 16-bit digits (< 2^36)."""
        if a.shape[1] <= _SKEW_MAX:
            buf = torch.zeros((NLIMBS, 2 * NLIMBS, a.shape[1]), dtype=torch.int64, device=a.device)
            t = _columns(a, b, buf)
            m = _normalize(_columns(t[:NLIMBS], self._c64("NPRIME", t), buf)[:NLIMBS], passes=4)
            u = (t + _columns(m, self._c64("P", t), buf))[NLIMBS - 2 :]
        else:
            tf = _columns_f64(a, b)
            halves = (self._toe("NPRIME", a.device) @ tf[:NLIMBS]).to(torch.int64)
            m = _normalize(halves[:NLIMBS] + (halves[NLIMBS:] << 8), passes=4)
            # U's columns are below 2^37, exact in float64 too.
            u = (tf + self._toe("P", a.device) @ m.to(torch.float64))[NLIMBS - 2 :].to(torch.int64)
        hi = u[2:]
        hi[0] += ((u[1] << LIMB_BITS) + u[0] + (1 << 22)) >> 32
        return _normalize(hi, passes=3).to(DTYPE)

    def _toe(self, name: str, device) -> torch.Tensor:
        """The float64 matrices of `_redc`'s wide products, cached per
        device: [32, 16] for "P" (p's product columns), and for "NPRIME"
        the low 16 product columns of -p^-1's low bytes over those of its
        high bytes."""
        key = (name, str(device), "toeplitz")
        t = self._cache.get(key)
        if t is None:
            if name == "P":
                t = _toeplitz(self.P, 2 * NLIMBS, device)
            else:
                lo = self.NPRIME.astype(np.int64) & 0xFF
                hi = self.NPRIME.astype(np.int64) >> 8
                t = torch.cat([_toeplitz(lo, NLIMBS, device), _toeplitz(hi, NLIMBS, device)])
            self._cache[key] = t
        return t

    def mul(self, a, b):
        """Montgomery product; the Montgomery-product kernel on CUDA tensors."""
        if self.plain:
            return self.mul_plain(a, b)
        from .cuda_mont import mont_mul

        return mont_mul(self.name, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    # -- Montgomery domain ------------------------------------------------
    def to_mont(self, a):
        return self.mul(a, self.const("R2", a.device, a.ndim))

    def from_mont(self, a):
        """Montgomery -> canonical integer limbs (< p)."""
        return self.canon(self.mul(a, self.const("ONE_RAW", a.device, a.ndim)))

    # -- exponentiation / inversion --------------------------------------
    def pow_bits(self, a, bits):
        """a^e for a static exponent given as MSB-first bits."""
        acc = self.full("ONE_MONT", a)
        for bit in bits:
            acc = self.mul(acc, acc)
            if bit:
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Batched inversion via Fermat (Montgomery form, nonzero inputs)."""
        return self.pow_bits(a, self._inv_bits)

    def _inv_host(self, a):
        """Invert the few elements of `a` on the host (0 maps to 0, as
        Fermat's a^(p-2) does): one fetch instead of a ~380-product device
        ladder.  Returns canonical Montgomery limbs on a's device."""
        p = self.modulus
        vals = [pow(v, -1, p) if v else 0 for v in self.from_mont_host_many(a)]
        return to_device(self.to_mont_host_many(vals), a.device).reshape(a.shape)

    def batch_inv(self, a):
        """Invert every element along the LAST axis via a product tree:
        pairwise products up, the root inverted on the host, the root
        inverse distributed back down.  All inputs must be nonzero."""
        n = a.shape[-1]
        if n == 1:
            return self._inv_host(a)
        m = 1 << (n - 1).bit_length()
        if m != n:
            one = self.const("ONE_MONT", a.device, a.ndim).expand(
                a.shape[:-1] + (m - n,)
            )
            a = torch.cat([a, one], dim=-1)
        levels = [a]
        cur = a
        while cur.shape[-1] > 1:
            cur = self.mul(cur[..., 0::2], cur[..., 1::2])
            levels.append(cur)
        inv = self._inv_host(levels[-1])
        for lvl in levels[-2::-1]:
            left = self.mul(inv, lvl[..., 1::2])
            right = self.mul(inv, lvl[..., 0::2])
            inv = torch.stack([left, right], dim=-1).reshape(lvl.shape)
        return inv[..., :n]

    def pow_int(self, a, e: int):
        """a^e for small static e, square-and-multiply."""
        if e == 0:
            return self.full("ONE_MONT", a)
        result = None
        base = a
        while e:
            if e & 1:
                result = base if result is None else self.mul(result, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return result

    # -- predicates (canonicalizing) --------------------------------------
    def is_zero(self, a):
        """canon(a) == 0, which holds for a = 0 and a = p only."""
        return torch.all(a == 0, dim=0) | torch.all(a == self.const("P", a.device, a.ndim), dim=0)

    def eq(self, a, b):
        return torch.all(self.canon(a) == self.canon(b), dim=0)

    @staticmethod
    def select(mask, a, b):
        """mask: bool[*batch]; picks a where True."""
        return torch.where(mask[None], a, b)


# The two BN254 fields.
from ..fields import FQ_MOD, FR_MOD  # noqa: E402

fq = FieldOps(FQ_MOD, "fq")
fr = FieldOps(FR_MOD, "fr")
fq_plain = FieldOps(FQ_MOD, "fq", plain=True)
fr_plain = FieldOps(FR_MOD, "fr", plain=True)
FIELDS = {"fq": fq, "fr": fr}
PLAIN_FIELDS = {"fq": fq_plain, "fr": fr_plain}
