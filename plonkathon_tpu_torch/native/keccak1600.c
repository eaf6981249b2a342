/* Keccak-f[1600] permutation — native backend for the Merlin transcript.
 *
 * The transcript is the only inherently serial host-side component of the
 * prover (every proof absorbs ~1KB and squeezes ~1.5KB through STROBE-128);
 * this C implementation replaces the pure-Python permutation when the
 * extension is built (see plonkathon_tpu/native/__init__.py), with identical
 * byte semantics (validated against the Python implementation and the
 * upstream Merlin conformance vector).
 */

#include <stdint.h>
#include <string.h>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static const int ROT[25] = {
    0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
    41, 45, 15, 21, 8, 18, 2, 61, 56, 14,
};

static inline uint64_t rotl(uint64_t v, int s) {
    return s == 0 ? v : (v << s) | (v >> (64 - s));
}

void keccak_f1600(uint8_t *state) {
    uint64_t lanes[25];
    uint64_t b[25];
    uint64_t c[5], d[5];
    memcpy(lanes, state, 200);
    for (int round = 0; round < 24; round++) {
        /* theta */
        for (int x = 0; x < 5; x++)
            c[x] = lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^
                   lanes[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
        for (int i = 0; i < 25; i++) lanes[i] ^= d[i % 5];
        /* rho + pi */
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(lanes[x + 5 * y], ROT[x + 5 * y]);
        /* chi */
        for (int i = 0; i < 25; i++) {
            int row = 5 * (i / 5);
            lanes[i] = b[i] ^ ((~b[(i + 1) % 5 + row]) & b[(i + 2) % 5 + row]);
        }
        /* iota */
        lanes[0] ^= RC[round];
    }
    memcpy(state, lanes, 200);
}
