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
device; plain arithmetic widens to int64, where 16x16-bit products and
their column sums never overflow.
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

    def _c64(self, name: str, like) -> torch.Tensor:
        key = (name, str(like.device), like.ndim, "i64")
        t = self._cache.get(key)
        if t is None:
            t = _col(getattr(self, name), like.ndim, like.device)
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

    def canon(self, a):
        """Lazy [0, 2p) -> canonical [0, p)."""
        return self._cond_sub(a.to(torch.int64), "P").to(DTYPE)

    def add(self, a, b):
        s = _carry1(a.to(torch.int64) + b.to(torch.int64))
        return self._cond_sub(s, "P2").to(DTYPE)

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
        d, borrow = _sub_limbs(a, b)
        d = d + torch.where(borrow[None], self._c64("P2", d), 0)
        return _carry1(d).to(DTYPE)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    # -- multiplication ---------------------------------------------------
    def mul_plain(self, a, b):
        """Montgomery product a*b*2^-256 mod p, lazy [0, 2p) in and out.

        Schoolbook columns in int64 (each < 2^36), then a digit-serial REDC
        over 16-bit digits: m_i zeroes digit i, m_i * p is added at column
        i, and the digit's carry moves up.  The sum of the m_i is the
        unique m < 2^256 with a*b + m*p = 0 mod 2^256, so the result is the
        same integer every Montgomery implementation gives.
        """
        a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
        t = torch.zeros((2 * NLIMBS + 1,) + a.shape[1:], dtype=torch.int64,
                        device=a.device)
        for i in range(NLIMBS):
            t[i : i + NLIMBS].addcmul_(a[i], b)
        p = self._c64("P", a)
        for i in range(NLIMBS):
            m = ((t[i] & LIMB_MASK) * self._n0) & LIMB_MASK
            t[i : i + NLIMBS].addcmul_(m, p)
            t[i + 1] += t[i] >> LIMB_BITS
        rows = []
        carry = t[NLIMBS]
        for k in range(NLIMBS, 2 * NLIMBS):
            v = carry if k == NLIMBS else t[k] + carry
            rows.append(v & LIMB_MASK)
            carry = v >> LIMB_BITS
        return torch.stack(rows).to(DTYPE)

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
        return torch.all(self.canon(a) == 0, dim=0)

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
