"""Commits whose width is not a power of two, on the CPU.

ZK blinding commits n + 2 and n + 3 coefficients, and the standalone
plookup's quotient 3n, on an SRS that need not be a power of two long.
Here Setup.generate(515) is held against the JAX package's host curve code
(plain Python, by integer coordinates), and commits of m = 514 and 515
through both routes (msm2, and msm3 on an engine whose threshold is
lowered for the test) against the host `ec_lincomb` over the same powers:
msm2's step padding and window gather, msm3's signed digits over 515-wide
tables and its plan's padded scan.  An SRS of n + 3 powers gets its window
tables n + 3 wide at the first commit of n, so the blinded commits after
it build no second table.
"""

import random

import pytest
import torch

from plonkathon_tpu.ec import G1, ec_lincomb, pt_mul
from plonkathon_tpu.fields import FR_MOD
from plonkathon_tpu.fields import Fr as JaxFr
from plonkathon_tpu_torch.kzg import Setup
from plonkathon_tpu_torch.ops.curve import FixedBaseMSM
from plonkathon_tpu_torch.ops.limbs import fr, to_device

from _torch_jax_bridge import ints, jax_g1

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

TAU = 0xDEADBEEF1337
N_SRS = 515


@pytest.fixture(scope="module")
def setup():
    return Setup.generate(N_SRS, tau=TAU, device="cpu")


@pytest.fixture(scope="module")
def engines(setup):
    """One engine per route over the same 515 powers; msm3's threshold is
    lowered so that m = 514 and 515 take it."""
    msm3_engine = FixedBaseMSM(setup.powers_of_x, device="cpu")
    msm3_engine._MSM3_MIN = 512
    return {"msm2": FixedBaseMSM(setup.powers_of_x, device="cpu"), "msm3": msm3_engine}


def test_setup_generate_non_power_of_two(setup):
    assert len(setup.powers_of_x) == N_SRS
    for i in (0, 1, 2, 256, 511, 512, 513, N_SRS - 1):
        assert ints(setup.powers_of_x[i]) == ints(pt_mul(G1, pow(TAU, i, FR_MOD))), i


@pytest.mark.parametrize("route", ["msm2", "msm3"])
@pytest.mark.parametrize("m", [514, 515])
def test_commit_non_power_of_two_width(setup, engines, route, m):
    rng = random.Random(m)
    coeffs = [rng.randrange(FR_MOD) for _ in range(m)]
    coeffs[0], coeffs[-1] = 0, FR_MOD - 1
    eng = engines[route]
    got = eng.commit_mont(to_device(fr.to_mont_host_many(coeffs), "cpu"))
    want = ec_lincomb([(jax_g1(p), JaxFr(c)) for p, c in zip(setup.powers_of_x, coeffs)])
    assert ints(got) == ints(want)
    # 514 and 515 both round up past the 515 powers: one table, 515 wide.
    assert (eng._tab16_n if route == "msm3" else eng._tab_n) == N_SRS


def test_blinded_srs_tables_built_once():
    """On an SRS of n + 3 powers, the first commit of n builds n + 3 wide
    tables; commits of n + 2 and n + 3 (the blinded ones) reuse them."""
    base = Setup.generate(11, tau=TAU, device="cpu")
    eng = FixedBaseMSM(base.powers_of_x, device="cpu")
    built = []
    real = eng._build_affine

    def spy(m):
        before = eng._tab_n
        real(m)
        if eng._tab_n != before:
            built.append(eng._tab_n)

    eng._build_affine = spy
    rng = random.Random(11)
    for m in (8, 10, 11):
        coeffs = [rng.randrange(FR_MOD) for _ in range(m)]
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * TAU + c) % FR_MOD
        got = eng.commit_mont(to_device(fr.to_mont_host_many(coeffs), "cpu"))
        assert ints(got) == ints(pt_mul(G1, acc)), m
    assert built == [11]
