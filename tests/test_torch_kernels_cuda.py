"""The CUDA kernels against their plain versions, on a card only.

Each test builds its inputs with numpy.random.default_rng, launches the
kernel on CUDA tensors and compares the result with the kernel's plain
torch version in raw limbs, exactly (integer arithmetic).  Edge lanes: 0,
p-1, 2p-1, the identity, P = Q, P = -Q and P + Q.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with the card and no JAX; it also holds the input builders that
the CPU kernel tests share.  Without a card every test here skips.  On
the card, from the repository root:

    python -m pytest -p no:cacheprovider --noconftest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu_torch.ec import G1, pt_mul, pt_neg
from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm2 as TM
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; on the chip run `python -m pytest "
                    "-p no:cacheprovider --noconftest -o addopts=\"\" -m cuda "
                    "tests/test_torch_kernels_cuda.py`")
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


@pytest.mark.cuda
def test_cuda_k5_equals_plain(cuda):
    a, b = (x.to(cuda) for x in point_pairs(np.random.default_rng(12), 1000))
    assert torch.equal(TM.jadd_stacked(a, b), TM.jadd_stacked_plain(a, b))


@pytest.mark.cuda
def test_cuda_k6_equals_plain(cuda):
    d_t, p_t, pts = (x.to(cuda) for x in scan_inputs(np.random.default_rng(13), 8, 300))
    assert torch.equal(TM.run_scan(d_t, p_t, pts), TM.run_scan_plain(d_t, p_t, pts))


@pytest.mark.cuda
def test_cuda_k7_equals_plain(cuda):
    a, _ = point_pairs(np.random.default_rng(14), 700)
    p = tuple(c.to(cuda) for c in coords(a))
    got = CM.jac_double_n(p, 8)
    want = CM.jac_double_n_plain(p, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_wrappers_count_launches(cuda):
    a = rand_limbs(np.random.default_rng(15), fr, 64).to(cuda)
    cuda_lib.reset_launches()
    CM.mont_mul("fr", a, a)
    CM.mont_mul_plain("fr", a, a)  # the plain version launches nothing
    assert cuda_lib.LAUNCHES["K1 fr"] == 1
