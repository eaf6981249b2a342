"""Merlin transcript (STROBE-128 over Keccak-f[1600]).

Bit-exact re-implementation of the Merlin construction the reference depends
on (external dep `merlin`, pyproject.toml:12).  Every proof's Fiat-Shamir
challenges flow through this, so byte-compatibility is validated end-to-end by
replaying the reference's recorded proof (test/proof.pickle) through the
verifier and by the upstream Merlin conformance vector in tests.
"""

from __future__ import annotations

from .keccak import keccak_f1600

_STROBE_R = 166

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    """Minimal STROBE-128 duplex supporting AD / meta-AD / PRF / KEY."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- duplex primitives ------------------------------------------------
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("flag mismatch on continued operation")
            return
        if flags & _FLAG_T:
            raise ValueError("transport operations unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_FLAG_C | _FLAG_K) and self.pos != 0:
            self._run_f()

    # -- operations -------------------------------------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class MerlinTranscript:
    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, n: int) -> None:
        self.append_message(label, n.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)
