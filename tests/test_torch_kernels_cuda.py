"""The CUDA kernels against their plain versions, on a card only.

Each test builds its inputs with numpy.random.default_rng, launches the
kernel on CUDA tensors and compares the result with the kernel's plain
torch version in raw limbs, exactly (integer arithmetic).  Edge lanes: 0,
p-1, 2p-1, the identity, P = Q, P = -Q and P + Q; for the packed incomplete
adds K3 and K4 every value of their mask bits.  Two tests hold paths
rather than one kernel: a commit 2^18 + 3 wide (ZK blinding's width) by
msm3 against msm2 on the card, and the standalone plookup's proof on the
card against the CPU's.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with the card and no JAX; it also holds the input builders that
the CPU kernel tests share.  Without a card every test here skips.  On
the card, from the repository root (with tests/test_torch_g1_cuda.py, the
point kernels K5, K6, K7 and K8b, whose place in the Tier-1 queue that
file's docstring explains):

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py tests/test_torch_g1_cuda.py

Its 19 tests are not `slow`, so xdist queues this file first of all in the
Tier-1 run, ahead of tests/test_sharded.py: the one port file allowed 7 or
more (tests/test_torch_build.py), because without a card its tests skip at
once and its worker takes its next file within the first second.
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu_torch.ec import G1, pt_mul, pt_neg
from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm3 as T3
from plonkathon_tpu_torch.ops.limbs import fq, fr, encode_ints, to_device

W = 32
FIELD_OPS = {"fr": fr, "fq": fq}


def rand_limbs(rng, ops, w=W, edges=True):
    """Lazy-domain [0, 2p) limbs int32[16, w]; lanes 0-2 are 0, p-1, 2p-1."""
    limbs = rng.integers(0, 1 << 16, size=(16, w), dtype=np.int64)
    limbs[15] = rng.integers(0, int(ops.P2[15]), size=w)
    if edges:
        p = ops.modulus
        limbs[:, :3] = encode_ints([0, p - 1, 2 * p - 1])
    return torch.from_numpy(limbs.astype(np.int32))


def real_point(k):
    """Stacked Jacobian [48, 1] of k*G (Z = 1) and of its negation."""
    g = pt_mul(G1, k)
    out = []
    for pt in (g, pt_neg(g)):
        x, y = (to_device(fq.to_mont_host(int(c)), "cpu")[:, None] for c in pt)
        out.append(torch.cat([x, y, fq.full("ONE_MONT", x)]))
    return out


def point_pairs(rng, w=W):
    """(a, b) stacked [48, w]: random coordinates, and in lanes 0-4:
    identity + P, P + identity, P + P, -P + P, P + Q (real points)."""
    a = torch.cat([rand_limbs(rng, fq, w, edges=False) for _ in range(3)])
    b = torch.cat([rand_limbs(rng, fq, w, edges=False) for _ in range(3)])
    p, neg_p = real_point(0xC0FFEE)
    q, _ = real_point(0xBEEF)
    ident = torch.cat([p[:32], torch.zeros_like(p[32:])])
    for lane, (pa, pb) in enumerate(((ident, p), (p, ident), (p, p), (neg_p, p), (p, q))):
        a[:, lane : lane + 1] = pa
        b[:, lane : lane + 1] = pb
    return a, b


def coords(stacked):
    return tuple(stacked[16 * i : 16 * (i + 1)] for i in range(stacked.shape[0] // 16))


def scan_inputs(rng, steps=4, chunks=8):
    """Sorted digit runs per chunk, prev as msm2 builds it, affine points;
    chunk 0 takes the same real point every step (doubling), chunk 1 the
    point and its negation (cancellation to the identity)."""
    dig = np.sort(rng.integers(0, 4, size=(chunks, steps)), axis=1)
    dig[:2] = 3
    prev = np.concatenate([dig[:, :1], dig[:, :-1]], axis=1)
    pts = torch.stack([rand_limbs(rng, fq, chunks, edges=False) for _ in range(2 * steps)])
    pts = pts.reshape(steps, 32, chunks)
    p, neg_p = real_point(0xC0FFEE)
    pts[:, :, 0] = p[:32, 0]
    for s in range(steps):
        pts[s, :, 1] = (p if s % 2 == 0 else neg_p)[:32, 0]
    d_t = torch.from_numpy(np.ascontiguousarray(dig.T, dtype=np.int32))
    p_t = torch.from_numpy(np.ascontiguousarray(prev.T, dtype=np.int32))
    return d_t, p_t, pts


def window_points(rng, n):
    """Window-major (X, Y, Z) [16, 32, n], as Setup.generate gathers them:
    point 0 is P in every window (a doubling at every level), point 1 P and
    -P alternating (cancellation, then identity + identity), point 2 P, Q,
    P, Q and then identities (a doubling of P + Q at level 2, Z != 1),
    point 3 identity + P and P + identity; random coordinates elsewhere,
    every 5th window of a point from 3 on the identity (a digit 0)."""
    stacked = torch.cat([rand_limbs(rng, fq, 32 * n, edges=False) for _ in range(3)])
    stacked = stacked.reshape(48, 32, n)
    stacked[32:, ::5, 3:] = 0
    p, neg_p = real_point(0xC0FFEE)
    q, _ = real_point(0xBEEF)
    ident = torch.cat([p[:32], torch.zeros_like(p[32:])])
    stacked[:, :, 0] = p
    stacked[:, :, 1] = torch.cat([p, neg_p], dim=1).repeat(1, 16)
    stacked[:, :, 2] = ident
    stacked[:, :4, 2] = torch.cat([p, q, p, q], dim=1)
    stacked[:, :4, 3] = torch.cat([ident, p, p, ident], dim=1)
    return coords(stacked)


def packed_inputs(rng, which, w=W):
    """(acc [24, w], q, mask [w]) for one K3 ("madd": q packed affine
    [16, w], mask lane % 4) or K4 ("jadd": q packed Jacobian [24, w], masks
    0, 1, 4, 5 in turn) step.  Random lazy limbs, except lanes 0-3: acc = P
    and q = Q, real points, under each mask value."""
    rows = 2 if which == "madd" else 3
    acc = torch.cat([rand_limbs(rng, fq, w, edges=False) for _ in range(3)])
    q = torch.cat([rand_limbs(rng, fq, w, edges=False) for _ in range(rows)])
    acc[:, :4] = real_point(0xC0FFEE)[0]
    q[:, :4] = real_point(0xBEEF)[0][: 16 * rows]
    values = [0, 1, 2, 3] if which == "madd" else [0, 1, 4, 5]
    mask = torch.tensor([values[i % 4] for i in range(w)], dtype=torch.int32)
    return T3.pack_array(acc), T3.pack_array(q), mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; on the chip run `python -m pytest "
                    "-p no:cacheprovider --noconftest -o addopts=\"\" -m cuda "
                    "tests/test_torch_kernels_cuda.py tests/test_torch_g1_cuda.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_k1_equals_plain(cuda):
    rng = np.random.default_rng(10)
    for field, ops in FIELD_OPS.items():
        a, b = rand_limbs(rng, ops, 4099).to(cuda), rand_limbs(rng, ops, 4099).to(cuda)
        assert torch.equal(CM.mont_mul(field, a, b), CM.mont_mul_plain(field, a, b)), field
        s = rand_limbs(rng, ops, 1, edges=False).to(cuda)  # a broadcast scalar
        assert torch.equal(CM.mont_mul(field, a, s), CM.mont_mul_plain(field, a, s)), field


@pytest.mark.cuda
def test_cuda_k2_equals_plain(cuda):
    rng = np.random.default_rng(11)
    c0, c1 = (rand_limbs(rng, fr, 96).reshape(16, 3, 8, 4).to(cuda) for _ in range(2))
    tw = rand_limbs(rng, fr, 8).reshape(16, 1, 8, 1).to(cuda)
    got = CM.dif_butterfly(c0, c1, tw)
    want = CM.dif_butterfly_plain(c0, c1, tw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def top_limbs(w, rows=16):
    """2p - 1 (Fq) in every coordinate: int32[rows, w] limbs."""
    col = torch.from_numpy(encode_ints([2 * fq.modulus - 1]))
    return col.repeat(rows // 16, w)


@pytest.mark.cuda
def test_cuda_wrappers_count_launches(cuda):
    a = rand_limbs(np.random.default_rng(15), fr, 64).to(cuda)
    cuda_lib.reset_launches()
    CM.mont_mul("fr", a, a)
    CM.mont_mul_plain("fr", a, a)  # the plain version launches nothing
    assert cuda_lib.LAUNCHES["K1 fr"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("which,steps", [("madd", 5), ("jadd", 5), ("madd", 12), ("jadd", 12)])
def test_cuda_k3_k4_equal_plain(cuda, which, steps):
    """One step, and a scan against the plain step applied `steps` times.
    The 12-step scans add long-run lanes (fresh at step 0, then never
    again: lanes 8-15; K3 negates at every step in 12-15, K4 ignores bit 1)
    and coordinates at 2p - 1 (the points of lanes 16-23, the start of
    lanes 20-27)."""
    rng = np.random.default_rng(16)
    step, plain = {
        "madd": (T3.madd_packed, T3.madd_packed_plain),
        "jadd": (T3.jadd_packed, T3.jadd_packed_plain),
    }[which]
    acc, q, mask = packed_inputs(rng, which, 1001)
    qs = torch.stack([q.roll(s, dims=1) for s in range(steps)])
    ms = torch.stack([mask.roll(s) for s in range(steps)])
    if steps > 5:
        ms[:, 8:16] = 0
        ms[0, 8:16] = 1
        ms[:, 12:16] |= 2
        qs[:, :, 16:24] = T3.pack_array(top_limbs(8, 16 * qs.shape[1] // 8))
        acc[:, 20:28] = T3.pack_array(top_limbs(8, 48))
    acc, q, mask, qs, ms = (x.to(cuda) for x in (acc, q, mask, qs, ms))
    assert torch.equal(step(acc, q, mask), plain(acc, q, mask))
    got = T3._inc_scan(which, acc, qs, ms)
    want = acc
    for s in range(steps):
        want = plain(want, qs[s], ms[s])
        assert torch.equal(got[s], want), s


@pytest.mark.cuda
def test_cuda_k8a_equals_plain(cuda):
    a, b = (coords(x.to(cuda)) for x in point_pairs(np.random.default_rng(17), 1000))
    cuda_lib.reset_launches()
    got, want = CM.jac_add(a, b), CM.jac_add_plain(a, b)
    assert cuda_lib.LAUNCHES["K8a add"] == 1 and cuda_lib.LAUNCHES["K8a"] == 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_k8a_window_sum_equals_plain(cuda):
    """One launch sums the 32 windows of 2^10 points (identity windows,
    doublings and cancellations at every level) as the plain halving does,
    in raw limbs; narrower trees too."""
    p = tuple(c.to(cuda) for c in window_points(np.random.default_rng(42), 1 << 10))
    cuda_lib.reset_launches()
    got = CM.jac_window_sum(p)
    assert cuda_lib.LAUNCHES["K8a"] == 1
    assert all(torch.equal(g, w) for g, w in zip(got, CM.jac_window_sum_plain(p)))
    for windows in (2, 4, 16):
        sub = tuple(c[:, :windows].contiguous() for c in p)
        got = CM.jac_window_sum(sub)
        assert all(torch.equal(g, w) for g, w in zip(got, CM.jac_window_sum_plain(sub)))


@pytest.mark.cuda
def test_cuda_setup_generate_one_window_launch(cuda):
    """Setup.generate on the card: one K8a launch, the CPU route's SRS."""
    from plonkathon_tpu_torch import Setup

    cuda_lib.reset_launches()
    got = Setup.generate(2**6, device=cuda)
    assert cuda_lib.LAUNCHES["K8a"] == 1 and cuda_lib.LAUNCHES["K8a add"] == 0
    assert got.powers_of_x == Setup.generate(2**6, device="cpu").powers_of_x


@pytest.mark.cuda
@pytest.mark.parametrize("w", [(1 << 10) + 37, 1 << 20])
def test_cuda_k8_operand_views_equal_plain(cuda, w):
    """K8a add and K8b on the operand views the wrappers hand over without
    a copy -- rows of one [48, w], q broadcast from [16, 1] (a column of a
    wider tensor, and a tensor of its own), the first w columns of a wider
    tensor -- and on a non-contiguous p (every other column), which the
    wrapper copies.  Lanes 0-4 of point_pairs: identity + P, P + identity,
    P + P, -P + P, P + Q; against q = P broadcast they add identity + P,
    P + P twice, -P + P and P + P."""
    rng = np.random.default_rng(20)
    a, b = (x.to(cuda) for x in point_pairs(rng, w))
    wide, _ = point_pairs(rng, 2 * w)
    wide = wide.to(cuda)
    pc, qc = coords(a), coords(b)
    cases = [
        (pc, qc),
        (pc, tuple(c[:, 2:3] for c in qc)),
        (pc, tuple(c[:, 2:3].contiguous() for c in qc)),
        (tuple(c[:, :w] for c in coords(wide)), qc),
        (tuple(c[:, ::2] for c in coords(wide)), qc),
    ]
    for p, q in cases:
        cuda_lib.reset_launches()
        got = CM.jac_add(p, q)
        got_m = CM.jac_madd(p, q[:2])
        assert cuda_lib.LAUNCHES["K8a add"] == 1 and cuda_lib.LAUNCHES["K8b"] == 1
        assert all(torch.equal(g, x) for g, x in zip(got, CM.jac_add_plain(p, q)))
        assert all(torch.equal(g, x) for g, x in zip(got_m, CM.jac_madd_plain(p, q[:2])))


@pytest.mark.cuda
def test_cuda_k9_equals_plain(cuda):
    rng = np.random.default_rng(19)
    e, o = (rand_limbs(rng, fr, 96).reshape(16, 3, 8, 4).to(cuda) for _ in range(2))
    tw = rand_limbs(rng, fr, 8).reshape(16, 1, 8, 1).to(cuda)
    got, want = CM.butterfly(e, o, tw), CM.butterfly_plain(e, o, tw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def fold_input(rng, w):
    """Stacked dense buckets [48, w] for the suffix fold: random
    coordinates, every 5th lane the identity (Z = 0), and real points where
    the fold's first up-sweep pairs (dense[w - 1 - 2i], dense[w - 2 - 2i])
    are P + P, P + (-P), identity + P and P + identity."""
    a, _ = point_pairs(rng, w)
    a[32:, ::5] = 0
    p, neg_p = real_point(0xC0FFEE)
    ident = torch.cat([p[:32], torch.zeros_like(p[32:])])
    for pair, (x, y) in enumerate(((p, p), (p, neg_p), (ident, p), (p, ident))):
        if 2 * pair + 2 <= w:
            a[:, w - 1 - 2 * pair : w - 2 * pair] = x
            a[:, w - 2 - 2 * pair : w - 1 - 2 * pair] = y
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1 << 4, 1 << 10, 1 << 15])
def test_cuda_k5_suffix_fold_equals_plain(cuda, w):
    """One launch of the whole fold against the plain fold on the CPU, in
    raw limbs."""
    dense = fold_input(np.random.default_rng(40), w)
    cuda_lib.reset_launches()
    got = T3.suffix_fold(dense.to(cuda))
    assert cuda_lib.LAUNCHES["K5"] == 1
    assert torch.equal(got.cpu(), T3.suffix_fold(dense))


@pytest.mark.cuda
def test_cuda_k4_dense_buckets_equals_plain(cuda):
    """Every multiplicity 0..J + 1 among 2^15 buckets, sorted keys with a
    _BIG tail, random packed points; one launch against the plain rounds
    on the card, dense limbs and max multiplicity."""
    rng = np.random.default_rng(41)
    nb, J = T3._NB2, T3._J
    mult = rng.integers(0, J + 2, size=nb)
    mult[:J + 2] = np.arange(J + 2)
    keys = np.repeat(np.arange(1, nb + 1), mult)
    keys = np.concatenate([keys, np.full(100, T3._BIG)]).astype(np.int32)
    T = len(keys)
    pts = T3.pack_array(torch.cat([rand_limbs(rng, fq, T, edges=False) for _ in range(3)]))
    pts[:, :8] = T3.pack_array(top_limbs(8, 48))
    k_t, p_t = torch.from_numpy(keys).to(cuda), pts.to(cuda)
    cuda_lib.reset_launches()
    dense, mm = T3._dense_buckets(k_t, p_t, J)
    assert cuda_lib.LAUNCHES["K4"] == 1
    want, want_mm = T3._dense_buckets_plain(k_t, p_t, J)
    assert int(mm) == int(want_mm) == J + 1
    assert torch.equal(dense, want)


@pytest.mark.cuda
def test_cuda_blinded_width_commit_msm3_equals_msm2(cuda):
    """A blinded-width commit, m = 2^18 + 3 on Setup.generate(2^18 + 3):
    msm3 (K3, K4, K5 over 2^18 + 3-wide tables) equals the card's own msm2
    route and the oracle p(tau) * G."""
    from plonkathon_tpu_torch import Setup
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.ops.curve import jac_to_affine_host

    m, tau = (1 << 18) + 3, 0xDEADBEEF1337
    setup = Setup.generate(m, tau=tau, device=cuda)
    rng = np.random.default_rng(42)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(m)]
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * tau + c) % FR_MOD
    dev = to_device(fr.to_mont_host_many(coeffs), cuda)
    eng = setup.msm_engine
    cuda_lib.reset_launches()
    res3, maxmult = eng.msm_mont_deferred(dev)
    assert int(maxmult) <= T3._J and cuda_lib.LAUNCHES["K3"] == 1
    assert eng._tab16_n == m
    res2 = eng._msm2_stacked(dev)
    assert cuda_lib.LAUNCHES["K6"] == 1
    got3, got2 = (jac_to_affine_host(r.reshape(3, 16)) for r in (res3, res2))
    assert got3 == got2 == pt_mul(G1, acc)


@pytest.mark.cuda
def test_cuda_plookup_equals_cpu(cuda):
    """The standalone plookup at n = 8 on the ceremony SRS: the card's
    proof equals the CPU's (plookup has no randomness) and verifies."""
    import os

    from plonkathon_tpu_torch import Setup
    from plonkathon_tpu_torch.lookup import prove_lookup, verify_lookup

    ptau = os.path.join(os.path.dirname(__file__), "fixtures", "powersOfTau28_hez_final_11.ptau")
    table, witness = [1, 5, 7, 11, 13, 17, 19, 23], [5, 13, 1, 5, 23, 7, 7]
    card = Setup.from_file(ptau, device=cuda)
    got = prove_lookup(card, table, witness)
    want = prove_lookup(Setup.from_file(ptau, device="cpu"), table, witness)
    assert got == want
    assert verify_lookup(card, table, got)
