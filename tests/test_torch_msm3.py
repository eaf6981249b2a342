"""The msm3 commit route end to end, and its routing, on the CPU.

With the synthetic SRS tau is known, so a commit has an exact oracle:
commit(p) == p(tau) * G, computed by the JAX package's host curve code
(plonkathon_tpu.ec: plain Python, compiles nothing) and compared by integer
coordinates, since the two packages have their own field classes.  The SRS
powers the engine is built on are held against the same host code.  Two
real commits at m = 512 go through the whole
pipeline (K3 scan, extraction, K4 merge and dense buckets, K5 Blelloch
fold, all through their plain versions) on an engine whose msm3 threshold
is lowered for the test; the routing at the real threshold m = 8192 is
checked with stubs that record which pipeline was called.
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu.ec import G1, pt_mul
from plonkathon_tpu.fields import FR_MOD
from plonkathon_tpu_torch.kzg import Setup
from plonkathon_tpu_torch.ops import msm3
from plonkathon_tpu_torch.ops.curve import FixedBaseMSM
from plonkathon_tpu_torch.ops.limbs import fr, to_device

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

TAU = 0xDEADBEEF1337
M = 512


def mont(coeffs):
    return to_device(fr.to_mont_host_many(coeffs), "cpu")


def ints(pt):
    """A point of either package as integer coordinates (None stays None)."""
    return None if pt is None else tuple(int(c) for c in pt)


def oracle(coeffs):
    """p(tau) * G by Horner on Python ints, as integer coordinates."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * TAU + c) % FR_MOD
    return ints(pt_mul(G1, acc))


@pytest.fixture(scope="module")
def setup():
    return Setup.generate(M, tau=TAU, device="cpu")


@pytest.fixture(scope="module")
def engine(setup):
    """An engine over Setup.generate(512) that routes m >= 512 to msm3."""
    eng = FixedBaseMSM(setup.powers_of_x, device="cpu")
    eng._MSM3_MIN = M
    return eng


@pytest.fixture
def routes(monkeypatch):
    """Record which pipeline a commit takes (and the multiplicity msm3
    reports), leaving both in place."""
    seen = []
    real3, real2 = msm3.msm_fixed_affine16, FixedBaseMSM._msm2_stacked

    def spy3(*args):
        res, maxmult = real3(*args)
        seen.append(("msm3", int(maxmult)))
        return res, maxmult

    monkeypatch.setattr(msm3, "msm_fixed_affine16", spy3)
    monkeypatch.setattr(
        FixedBaseMSM, "_msm2_stacked", lambda self, c: seen.append("msm2") or real2(self, c))
    return seen


def test_setup_powers_match_host_oracle(setup):
    """The SRS both commits below run on: tau^i * G at both ends and at a
    few indices between."""
    assert len(setup.powers_of_x) == M
    for i in (0, 1, 2, 15, 16, 17, 255, 256, 300, M - 2, M - 1):
        assert ints(setup.powers_of_x[i]) == ints(pt_mul(G1, pow(TAU, i, FR_MOD))), i


def test_msm3_commit_matches_oracle(engine, routes):
    rng = np.random.default_rng(120)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(M)]
    coeffs[0] = 0  # a zero digit row: key 0, dropped at extraction
    coeffs[1] = FR_MOD - 1
    coeffs[2] = 1 << 15  # digit 2^15 stays positive
    coeffs[3] = (1 << 15) + 1  # recodes to -(2^15 - 1) with a carry
    assert ints(engine.commit_mont(mont(coeffs))) == oracle(coeffs)
    assert [r[0] for r in routes] == ["msm3"] and routes[0][1] <= msm3._J


def test_msm3_overflow_falls_back_to_msm2(engine, routes):
    """Every limb of every coefficient is 0x1234: all 16 * 512 insertions
    share one bucket, more run ends than the dense stage folds."""
    c = sum(0x1234 << (16 * w) for w in range(16))
    assert c < FR_MOD
    assert ints(engine.commit_mont(mont([c] * M))) == oracle([c] * M)
    assert routes == [("msm3", 16), "msm2"]  # 256 chunk ends merge 16 to a lane
    assert 16 > msm3._J


class _Stubbed(FixedBaseMSM):
    """Records the route; computes nothing."""

    def __init__(self, n, overflow=()):
        super().__init__([None] * n, device="cpu")
        self.calls = []
        self.overflow = set(overflow)

    def _build_affine16(self, m):
        self._tab16_n = self._need(m)

    def _digits16(self, coeffs_mont):
        return coeffs_mont, None

    def _msm2_stacked(self, coeffs_mont):
        self.calls.append(("msm2", coeffs_mont.shape[-1]))
        return torch.zeros(48, dtype=torch.int32)


@pytest.fixture
def stub_msm3(monkeypatch):
    def fake(tabp, key, payload):
        eng, tag = fake.engine, int(key[0, 0])
        eng.calls.append(("msm3", key.shape[-1]))
        mm = msm3._J + 1 if tag in eng.overflow else msm3._J
        return torch.zeros(48, dtype=torch.int32), torch.tensor(mm)

    monkeypatch.setattr(msm3, "msm_fixed_affine16", fake)
    return fake


@pytest.mark.parametrize("m, route", [(8191, "msm2"), (8192, "msm3")])
def test_route_threshold(stub_msm3, m, route):
    assert FixedBaseMSM._MSM3_MIN == 8192
    eng = stub_msm3.engine = _Stubbed(1 << 14)
    assert eng.commit_mont(torch.zeros((16, m), dtype=torch.int32)) is None
    assert eng.calls == [(route, m)]
    with pytest.raises(ValueError):
        eng.commit_mont(torch.zeros((16, (1 << 14) + 1), dtype=torch.int32))


def test_commit_batch_recommits_only_the_overflow(stub_msm3):
    """Results and multiplicities come back together; only the polynomial
    whose multiplicity exceeds _J goes through msm2 afterwards, and a
    multiplicity of exactly _J stands."""
    eng = stub_msm3.engine = _Stubbed(1 << 13, overflow={7})
    polys = [torch.full((16, 8192), tag, dtype=torch.int32) for tag in (5, 7)]
    polys.append(torch.zeros((16, 64), dtype=torch.int32))
    assert eng.commit_batch(polys) == [None, None, None]  # Z = 0 everywhere
    assert eng.calls == [("msm3", 8192), ("msm3", 8192), ("msm2", 64), ("msm2", 8192)]
