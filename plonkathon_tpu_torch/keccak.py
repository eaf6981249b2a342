"""Keccak-f[1600] permutation (backs the STROBE-128/Merlin transcript).

Standard permutation operating in place on a 200-byte bytearray with the
little-endian lane mapping.  Dispatches to the native C implementation
(plonkathon_tpu_torch/native) when it builds; the pure-Python version below is the
always-available fallback and the semantic reference.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets indexed by lane (x + 5*y).
_ROT = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)


def _rotl(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & _MASK


def _keccak_f1600_py(state: bytearray) -> None:
    """Apply Keccak-f[1600] in place to a 200-byte state (pure Python)."""
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        lanes = [lanes[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(lanes[x + 5 * y], _ROT[x + 5 * y])
        # chi
        lanes = [
            b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)]) & b[(i + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        lanes[0] ^= rc
    for i in range(25):
        state[8 * i : 8 * i + 8] = lanes[i].to_bytes(8, "little")


def _resolve():
    try:
        from .native import load_keccak

        native = load_keccak()
        if native is not None:
            return native
    except Exception:
        pass
    return _keccak_f1600_py


keccak_f1600 = _resolve()
