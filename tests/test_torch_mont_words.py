"""The carry-chain field arithmetic of csrc/field.cuh, word for word (CPU).

`fe_mul_ptx` (CIOS), `fe_sqr_ptx` (the square from its cross products
once, then a word-by-word REDC), `fe_add_ptx` and `fe_sub_ptx` are sequences of
PTX instructions that pass a carry flag from one to the next.  This file
runs the same sequences on Python integers -- 32-bit words, the flag, the
instructions in the order the CUDA source issues them -- and holds the
results against the bodies of the TPU kernels (`pallas_mont.KR` / `KQ`,
called as plain jnp functions, as tests/test_torch_kernels.py does) in raw
limbs.  Every place where an instruction drops its carry out asserts that
the carry is zero, which is the header's claim that inputs below 2p keep
every intermediate within its words.  Edge lanes 0, 1, p - 1 and 2p - 1, in
every pairing, and random lazy-domain lanes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from plonkathon_tpu.ops import pallas_mont as PM
from plonkathon_tpu_torch.ops.cuda_mont import field_consts
from plonkathon_tpu_torch.ops.limbs import decode_ints, encode_ints, fq, fr

FIELDS = {"fr": (fr, PM.KR), "fq": (fq, PM.KQ)}
M32 = (1 << 32) - 1


class Ptx:
    """The PTX integer instructions field.cuh uses, with the carry flag.

    Without `.cc` an instruction leaves the flag as it was and drops its
    carry out, which must then be zero."""

    def __init__(self):
        self.cf = 0

    def _put(self, v, cc):
        if cc:
            self.cf = v >> 32
        else:
            assert v >> 32 == 0, "a dropped carry was not zero"
        return v & M32

    def add_cc(self, a, b):
        return self._put(a + b, True)

    def addc_cc(self, a, b):
        return self._put(a + b + self.cf, True)

    def addc(self, a, b):
        return self._put(a + b + self.cf, False)

    def sub_cc(self, a, b):
        d = a - b
        self.cf = int(d < 0)
        return d & M32

    def subc_cc(self, a, b):
        d = a - b - self.cf
        self.cf = int(d < 0)
        return d & M32

    def subc(self, a, b):
        return (a - b - self.cf) & M32

    def mad_lo_cc(self, a, b, c):
        return self._put(((a * b) & M32) + c, True)

    def madc_lo_cc(self, a, b, c):
        return self._put(((a * b) & M32) + c + self.cf, True)

    def mad_hi_cc(self, a, b, c):
        return self._put((a * b >> 32) + c, True)

    def madc_hi_cc(self, a, b, c):
        return self._put((a * b >> 32) + c + self.cf, True)

    def madc_hi(self, a, b, c):
        return self._put((a * b >> 32) + c + self.cf, False)


def mul_cios(x, a, b, p, n0):
    """fe_mul_ptx: CIOS, row i adds a * b_i, then m_i * p, then shifts."""
    t = [0] * 9
    for i in range(8):
        t[0] = x.mad_lo_cc(a[0], b[i], t[0])
        for j in range(1, 8):
            t[j] = x.madc_lo_cc(a[j], b[i], t[j])
        t[8] = x.addc(0, 0)
        t[1] = x.mad_hi_cc(a[0], b[i], t[1])
        for j in range(1, 7):
            t[j + 1] = x.madc_hi_cc(a[j], b[i], t[j + 1])
        t[8] = x.madc_hi(a[7], b[i], t[8])
        m = (t[0] * n0) & M32
        t[0] = x.mad_lo_cc(m, p[0], t[0])
        assert t[0] == 0
        for j in range(1, 8):
            t[j] = x.madc_lo_cc(m, p[j], t[j])
        t[8] = x.addc(t[8], 0)
        t[1] = x.mad_hi_cc(m, p[0], t[1])
        for j in range(1, 7):
            t[j + 1] = x.madc_hi_cc(m, p[j], t[j + 1])
        t[8] = x.madc_hi(m, p[7], t[8])
        t = t[1:] + [t[8]]  # the register moves t[k] = t[k + 1]
    return t[:8]


def sqr_wide(x, a):
    """sqr_wide: the 16 words of a^2 from the cross products once."""
    t = [0] + [(a[j] * a[0]) & M32 for j in range(1, 8)] + [0] * 8
    t[2] = x.mad_hi_cc(a[1], a[0], t[2])
    for j in range(2, 7):
        t[j + 1] = x.madc_hi_cc(a[j], a[0], t[j + 1])
    t[8] = x.madc_hi(a[7], a[0], 0)
    for i in range(1, 7):
        t[2 * i + 1] = x.mad_lo_cc(a[i + 1], a[i], t[2 * i + 1])
        for j in range(i + 2, 8):
            t[i + j] = x.madc_lo_cc(a[j], a[i], t[i + j])
        t[i + 8] = x.addc(0, 0)
        if i + 1 == 7:
            s = (a[7] * a[6] >> 32) + t[14]  # __umulhi + t: plain C
            assert s >> 32 == 0
            t[14] = s
        else:
            t[2 * i + 2] = x.mad_hi_cc(a[i + 1], a[i], t[2 * i + 2])
            for j in range(i + 2, 7):
                t[i + j + 1] = x.madc_hi_cc(a[j], a[i], t[i + j + 1])
            t[i + 8] = x.madc_hi(a[7], a[i], t[i + 8])
    t[1] = x.add_cc(t[1], t[1])
    for k in range(2, 15):
        t[k] = x.addc_cc(t[k], t[k])
    t[15] = x.addc(0, 0)
    t[0] = (a[0] * a[0]) & M32
    t[1] = x.mad_hi_cc(a[0], a[0], t[1])
    for i in range(1, 7):
        t[2 * i] = x.madc_lo_cc(a[i], a[i], t[2 * i])
        t[2 * i + 1] = x.madc_hi_cc(a[i], a[i], t[2 * i + 1])
    t[14] = x.madc_lo_cc(a[7], a[7], t[14])
    t[15] = x.madc_hi(a[7], a[7], t[15])
    return t


def redc_wide(x, t, p, n0):
    """redc_wide: (t + m p) / 2^256, one digit m_i per row."""
    owed = 0
    for i in range(8):
        m = (t[i] * n0) & M32
        t[i] = x.mad_lo_cc(m, p[0], t[i])
        assert t[i] == 0
        for j in range(1, 8):
            t[i + j] = x.madc_lo_cc(m, p[j], t[i + j])
        t[i + 8] = x.addc_cc(t[i + 8], owed)
        low_out = x.addc(0, 0)
        t[i + 1] = x.mad_hi_cc(m, p[0], t[i + 1])
        for j in range(1, 8):
            t[i + j + 1] = x.madc_hi_cc(m, p[j], t[i + j + 1])
        owed = x.addc(low_out, 0)
    assert owed == 0, "a carry was owed to word 16"
    return t[8:]


def add_ptx(x, a, b, p2):
    s = [x.add_cc(a[0], b[0])] + [x.addc_cc(a[k], b[k]) for k in range(1, 7)]
    s.append(x.addc(a[7], b[7]))
    d = [x.sub_cc(s[0], p2[0])] + [x.subc_cc(s[k], p2[k]) for k in range(1, 8)]
    borrow = x.subc(0, 0)
    return s if borrow else d


def sub_ptx(x, a, b, p2):
    d = [x.sub_cc(a[0], b[0])] + [x.subc_cc(a[k], b[k]) for k in range(1, 8)]
    borrow = x.subc(0, 0)
    r = [x.add_cc(d[0], p2[0] & borrow)]
    r += [x.addc_cc(d[k], p2[k] & borrow) for k in range(1, 7)]
    # The sum wraps past 2^256 exactly when it corrects a borrow: addc.u32
    # drops that carry, so the model drops it too.
    r.append((d[7] + (p2[7] & borrow) + x.cf) & M32)
    return r


def words(v):
    return [(v >> (32 * k)) & M32 for k in range(8)]


def value(ws):
    return sum(w << (32 * k) for k, w in enumerate(ws))


def consts(field):
    """p, 2p and n0 = -p^-1 mod 2^32 as the kernels receive them."""
    buf = list(field_consts(field))
    return buf[0:8], buf[8:16], buf[24]


def lanes(field, seed):
    """Edge values 0, 1, p - 1, 2p - 1 in every pairing, then random lazy
    lanes: (a, b) lists of ints below 2p."""
    ops = FIELDS[field][0]
    p = ops.modulus
    edge = [0, 1, p - 1, 2 * p - 1]
    a = [u for u in edge for _ in edge]
    b = [v for _ in edge for v in edge]
    rng = np.random.default_rng(seed)
    for _ in range(48):
        a.append(int.from_bytes(rng.bytes(32), "little") % (2 * p))
        b.append(int.from_bytes(rng.bytes(32), "little") % (2 * p))
    return a, b


def body(fn, *xs):
    """A TPU kernel body on lanes of ints -> list of ints."""
    cols = [encode_ints(x).astype(np.uint32) for x in xs]
    out = fn(*([jnp.asarray(c[k]) for k in range(16)] for c in cols))
    return decode_ints(np.stack([np.asarray(o) for o in out]).astype(np.int32))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_word_product_and_square_match_kernel_bodies(field):
    K = FIELDS[field][1]
    p, _, n0 = consts(field)
    a, b = lanes(field, 31)
    x = Ptx()
    got_mul = [value(mul_cios(x, words(u), words(v), p, n0)) for u, v in zip(a, b)]
    got_sqr = [value(redc_wide(x, sqr_wide(x, words(u)), p, n0)) for u in a]
    assert got_mul == body(K.mul, a, b)
    assert got_sqr == body(K.sqr, a)
    # The square's cross-product schedule gives the 16 words of a^2.
    for u in a:
        assert value(sqr_wide(x, words(u))) == u * u


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_word_add_sub_match_kernel_bodies(field):
    K = FIELDS[field][1]
    _, p2, _ = consts(field)
    a, b = lanes(field, 32)
    x = Ptx()
    assert [value(add_ptx(x, words(u), words(v), p2)) for u, v in zip(a, b)] == body(K.add, a, b)
    assert [value(sub_ptx(x, words(u), words(v), p2)) for u, v in zip(a, b)] == body(K.sub, a, b)
