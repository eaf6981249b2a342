"""The proof's Fiat-Shamir transcript on plain Python: Keccak-f[1600],
STROBE-128 (the subset Merlin uses) and Merlin, then the PLONK schedule of
labels.  Points go in as two 32-byte big-endian coordinates, scalars as 32
big-endian bytes; a challenge is 255 squeezed bytes read big-endian mod r,
drawn again while it is 0, and absorbed back under its label."""

from __future__ import annotations

from .bn254 import R

_M64 = (1 << 64) - 1
_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# rho offsets, lane index x + 5y
_RHO = (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14)


def keccak_f1600(state: bytearray) -> None:
    a = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        for x in range(5):
            r = c[(x + 1) % 5]
            d = c[(x - 1) % 5] ^ (((r << 1) | (r >> 63)) & _M64)
            for y in range(0, 25, 5):
                a[x + y] ^= d
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                v, s = a[x + 5 * y], _RHO[x + 5 * y]
                b[y + 5 * ((2 * x + 3 * y) % 5)] = ((v << s) | (v >> (64 - s))) & _M64 if s else v
        a = [b[i] ^ ((~b[(i % 5 + 1) % 5 + i - i % 5]) & b[(i % 5 + 2) % 5 + i - i % 5])
             for i in range(25)]
        a[0] ^= rc
    for i in range(25):
        state[8 * i: 8 * i + 8] = a[i].to_bytes(8, "little")


class _Strobe:
    RATE = 166
    I, A, C, T, M, K = 1, 2, 4, 8, 16, 32

    def __init__(self, label: bytes):
        self.st = bytearray(200)
        self.st[0:6] = bytes([1, self.RATE + 2, 1, 0, 1, 96])
        self.st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(self.st)
        self.pos = self.begin = self.flags = 0
        self.op(self.M | self.A, label)

    def _run(self):
        self.st[self.pos] ^= self.begin
        self.st[self.pos + 1] ^= 0x04
        self.st[self.RATE + 1] ^= 0x80
        keccak_f1600(self.st)
        self.pos = self.begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.st[self.pos] ^= byte
            self.pos += 1
            if self.pos == self.RATE:
                self._run()

    def _start(self, flags: int):
        old = self.begin
        self.begin = self.pos + 1
        self.flags = flags
        self._absorb(bytes([old, flags]))
        if flags & (self.C | self.K) and self.pos != 0:
            self._run()

    def op(self, flags: int, data: bytes, more: bool = False):
        """An AD or meta-AD operation; `more` continues the last one."""
        if not more:
            self._start(flags)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._start(self.I | self.A | self.C)
        out = bytearray()
        for _ in range(n):
            out.append(self.st[self.pos])
            self.st[self.pos] = 0
            self.pos += 1
            if self.pos == self.RATE:
                self._run()
        return bytes(out)


class Transcript:
    """Merlin v1.0 with the PLONK transcript's encodings."""

    def __init__(self, label: bytes = b"plonk"):
        self.s = _Strobe(b"Merlin v1.0")
        self.message(b"dom-sep", label)

    def message(self, label: bytes, data: bytes):
        self.s.op(_Strobe.M | _Strobe.A, label)
        self.s.op(_Strobe.M | _Strobe.A, len(data).to_bytes(4, "little"), more=True)
        self.s.op(_Strobe.A, data)

    def point(self, label: bytes, p):
        x, y = p  # an identity commitment cannot be encoded: it raises here
        self.message(label, x.to_bytes(32, "big"))
        self.message(label, y.to_bytes(32, "big"))

    def scalar(self, label: bytes, k: int):
        self.message(label, k.to_bytes(32, "big"))

    def challenge(self, label: bytes) -> int:
        while True:
            self.s.op(_Strobe.M | _Strobe.A, label)
            self.s.op(_Strobe.M | _Strobe.A, (255).to_bytes(4, "little"), more=True)
            raw = self.s.prf(255)
            value = int.from_bytes(raw, "big") % R
            if value:
                self.message(label, raw)
                return value
