"""The port's fixed-base MSM and synthetic setup against host oracles (CPU).

* FixedBaseMSM commits (the msm2 pipeline: K6 run-scan, K5 folds, K7
  window tables, all through their plain versions here) against the JAX
  package's host oracle plonkathon_tpu.ec.ec_lincomb, as affine points;
* Setup.generate against its pt_mul(G1, tau^i).

Points are compared by integer coordinates (the two packages have their
own field classes); the JAX package's ec module is plain Python and
compiles nothing.
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu.ec import G1, ec_lincomb, pt_mul
from plonkathon_tpu.fields import FR_MOD
from plonkathon_tpu_torch.fields import Fq
from plonkathon_tpu_torch.kzg import Setup
from plonkathon_tpu_torch.ops import msm2
from plonkathon_tpu_torch.ops.curve import FixedBaseMSM
from plonkathon_tpu_torch.ops.limbs import fr, to_device

torch.set_num_threads(1)  # small tensors: threads only contend with xdist


def ints(pt):
    """A point of either package as integer coordinates (None stays None)."""
    return None if pt is None else tuple(int(c) for c in pt)


@pytest.fixture(scope="module")
def msm_engine():
    rng = np.random.default_rng(107)
    pts = [pt_mul(G1, int(k)) for k in rng.integers(1, 2**62, size=300)]
    eng = FixedBaseMSM([(Fq(int(x)), Fq(int(y))) for x, y in pts], device="cpu")
    eng._build_affine(len(pts))  # one table build serves every commit size
    return pts, eng


@pytest.mark.parametrize("m", [8, 64, 300])
def test_msm_commit_matches_host_oracle(msm_engine, m):
    pts, eng = msm_engine
    rng = np.random.default_rng(108 + m)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(m)]
    coeffs[0] = 0  # a zero digit row
    coeffs[-1] = FR_MOD - 1
    got = eng.commit_mont(to_device(fr.to_mont_host_many(coeffs), "cpu"))
    assert ints(got) == ints(ec_lincomb(list(zip(pts[:m], coeffs))))


def test_msm_commit_batch_and_zero_polynomial(msm_engine):
    pts, eng = msm_engine
    zero = torch.zeros((16, 8), dtype=torch.int32)
    ones = to_device(fr.to_mont_host_many([1] * 8), "cpu")
    got = eng.commit_batch([zero, ones])
    assert got[0] is None
    assert ints(got[1]) == ints(ec_lincomb([(p, 1) for p in pts[:8]]))


def test_setup_generate_matches_host_powers():
    tau = 0xDEADBEEF1337
    setup = Setup.generate(16, tau=tau, device="cpu")
    want = [pt_mul(G1, pow(tau, i, FR_MOD)) for i in range(16)]
    assert [ints(p) for p in setup.powers_of_x] == [ints(p) for p in want]


def test_chunk_plan():
    """C is a power of two near k/16 (at most 2^14); steps round up to 16
    past 16, which covers the m = 544 commit (k = 17408)."""
    for k, chunks, steps in ((256, 16, 16), (17408, 1024, 32), (1 << 21, 1 << 14, 128)):
        c = msm2._choose_chunks(k)
        s = -(-k // c)
        if s > 16:
            s = -(-s // 16) * 16
        assert (c, s) == (chunks, steps), k
