"""The SRS checkpoint cache (`srs_cache=`) and the rest of the JAX package's
public MSM, polynomial and prover surface, on the CPU.

The synthetic SRS's `.gen` file is held in both directions against the JAX
package's format (its cache-read path returns before any jit); the window
tables' cache files of both routes against a build, raw limb for raw
limb, and stale,
foreign and too narrow files are shown to be rebuilt.  Commits are held
against the JAX package's host `ec_lincomb` / `pt_mul` (plain Python, by
integer coordinates).  Builds are caught by wrappers that count them, or
that raise where a cache hit must not build.  n <= 64: plain CPU commits
cost about a second each (an msm3 one about ten), so the engines that
need tables share one module fixture.
"""

import os
import random
import shutil

import numpy as np
import pytest
import torch

from plonkathon_tpu.ec import G1, G2, ec_lincomb, pt_add, pt_mul
from plonkathon_tpu.fields import FR_MOD
from plonkathon_tpu.fields import Fr as JaxFr
from plonkathon_tpu_torch import Basis, Polynomial, Program, Prover, Setup
from plonkathon_tpu_torch.fields import Fr
from plonkathon_tpu_torch.ops import cuda_mont, msm2, msm3
from plonkathon_tpu_torch.ops import curve as C
from plonkathon_tpu_torch.ops.limbs import fq, fr, to_device

from _torch_jax_bridge import ints, jax_g1

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

TAU = 0xDEADBEEF1337
TAU2 = 0xABCDEF12345
N = 64
SAMPLES = (0, 1, 2, 5, 33, N - 1)


def mont(coeffs):
    return to_device(fr.to_mont_host_many(coeffs), "cpu")


def random_coeffs(seed: int, m: int):
    rng = random.Random(seed)
    coeffs = [rng.randrange(FR_MOD) for _ in range(m)]
    coeffs[0], coeffs[-1] = 0, FR_MOD - 1
    return coeffs


def lincomb(points, coeffs):
    """The host oracle, as integer coordinates."""
    return ints(ec_lincomb([(jax_g1(p), JaxFr(c)) for p, c in zip(points, coeffs)]))


def jac_ints(p):
    return ints(C.jac_to_affine_host(p))


def assert_powers(setup, tau):
    for i in SAMPLES:
        assert ints(setup.powers_of_x[i]) == ints(pt_mul(G1, pow(tau, i, FR_MOD))), i
    assert [[int(c) for c in v.coeffs] for v in setup.X2] == [
        [int(c) for c in v.coeffs] for v in pt_mul(G2, tau)]


def raising(what):
    def stub(*args, **kwargs):
        raise AssertionError(f"{what} ran on a cache hit")
    return stub


def counting(fn, calls: list):
    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    return wrapped


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("srs_cache")


@pytest.fixture(scope="module")
def srs(cache_dir):
    """Setup.generate(64) on the CPU with a cache prefix: writes its .gen."""
    return Setup.generate(N, TAU, srs_cache=str(cache_dir / "srs"), device="cpu")


@pytest.fixture(scope="module")
def engine(srs, cache_dir):
    """An engine over the 64 powers with its msm2 and msm3 tables built
    and written under its own prefix."""
    eng = C.FixedBaseMSM(srs.powers_of_x, device="cpu", cache_path=str(cache_dir / "eng"))
    eng._build_affine(N)
    eng._build_affine16(N)
    return eng


def test_gen_cache_round_trip(srs, cache_dir, monkeypatch):
    prefix = str(cache_dir / "srs")
    assert os.path.exists(f"{prefix}.gen{N}.npz")
    assert_powers(srs, TAU)
    monkeypatch.setattr(cuda_mont, "jac_window_sum", raising("the window sum"))
    again = Setup.generate(N, TAU, srs_cache=prefix, device="cpu")
    assert again.powers_of_x == srs.powers_of_x and again.X2 == srs.X2
    assert again.srs_cache == prefix and again.msm_engine.cache_path == prefix


def test_gen_cache_cross_package(srs, cache_dir, monkeypatch):
    """The port's file loads in the JAX package (a fallback to generating
    would call the patched jac_fold_sum), and a file written with the JAX
    package's host limb code (uint32) loads in the port."""
    from plonkathon_tpu import kzg as jax_kzg
    from plonkathon_tpu.ops import curve as jax_curve
    from plonkathon_tpu.ops.limbs import fq as jax_fq

    monkeypatch.setattr(jax_curve, "jac_fold_sum", raising("the JAX package's fold"))
    theirs = jax_kzg.Setup.generate(N, TAU, srs_cache=str(cache_dir / "srs"))
    assert [ints(p) for p in theirs.powers_of_x] == [ints(p) for p in srs.powers_of_x]

    prefix = str(cache_dir / "jax")
    ax = jax_fq.to_mont_host_many([int(p[0]) for p in srs.powers_of_x])
    ay = jax_fq.to_mont_host_many([int(p[1]) for p in srs.powers_of_x])
    assert ax.dtype == np.uint32
    np.savez(f"{prefix}.gen{N}.npz", n=N, tau=TAU, ax=ax, ay=ay)
    monkeypatch.setattr(cuda_mont, "jac_window_sum", raising("the window sum"))
    ours = Setup.generate(N, TAU, srs_cache=prefix, device="cpu")
    assert ours.powers_of_x == srs.powers_of_x and ours.X2 == srs.X2


def test_stale_caches_rebuilt(srs, cache_dir, engine, monkeypatch):
    """A .gen file of another tau, a table file of another SRS of the same
    n, and a table file narrower than `_need(m)` are each a miss: rebuilt,
    and the commit is right."""
    prefix = str(cache_dir / "stale")
    shutil.copy(cache_dir / f"srs.gen{N}.npz", f"{prefix}.gen{N}.npz")
    sums = []
    monkeypatch.setattr(cuda_mont, "jac_window_sum", counting(cuda_mont.jac_window_sum, sums))
    other = Setup.generate(N, TAU2, srs_cache=prefix, device="cpu")
    assert len(sums) == 1
    assert_powers(other, TAU2)

    # The tables of the tau SRS, 64 wide, under the prefix of the tau2 one.
    shutil.copy(cache_dir / f"eng.affine{N}.npz", f"{prefix}.affine{N}.npz")
    builds = []
    monkeypatch.setattr(msm2, "build_affine_tables", counting(msm2.build_affine_tables, builds))
    coeffs = random_coeffs(8, 8)  # _need(8) = 11
    foreign = C.FixedBaseMSM(other.powers_of_x, device="cpu", cache_path=prefix)
    assert ints(foreign.commit_mont(mont(coeffs))) == lincomb(other.powers_of_x, coeffs)
    assert len(builds) == 1 and foreign._tab_n == 11
    assert os.path.exists(f"{prefix}.affine11.npz")

    wider = random_coeffs(20, 20)  # _need(20) = 35: the 11-wide file is too narrow
    narrow = C.FixedBaseMSM(other.powers_of_x, device="cpu", cache_path=prefix)
    assert ints(narrow.commit_mont(mont(wider))) == lincomb(other.powers_of_x, wider)
    assert len(builds) == 2 and narrow._tab_n == 35
    again = C.FixedBaseMSM(other.powers_of_x, device="cpu", cache_path=prefix)
    assert ints(again.commit_mont(mont(coeffs))) == lincomb(other.powers_of_x, coeffs)
    assert len(builds) == 2 and again._tab_n == 35  # the widest file of this SRS


def test_table_cache_round_trip_both_routes(srs, cache_dir, engine, monkeypatch):
    """Both routes' tables written by one engine load in a second, equal
    raw limb for raw limb (so an msm3 commit on them is the built one's),
    and the second commits with every table build patched to raise."""
    prefix = str(cache_dir / "eng")
    assert os.path.exists(f"{prefix}.affine{N}.npz")
    assert os.path.exists(f"{prefix}.affine16p_{N}.npz")
    monkeypatch.setattr(msm2, "build_affine_tables", raising("the msm2 table build"))
    monkeypatch.setattr(msm3, "build_affine_tables16", raising("the msm3 table build"))
    loaded = C.FixedBaseMSM(srs.powers_of_x, device="cpu", cache_path=prefix)
    loaded._build_affine(N)
    loaded._build_affine16(N)
    assert loaded._tab_n == loaded._tab16_n == N
    for got, want in zip(loaded.affine_tab + (loaded.affine16_tab,),
                         engine.affine_tab + (engine.affine16_tab,)):
        assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    assert int(engine.affine16_tab.min()) < 0  # sign-extended words survived

    coeffs = random_coeffs(64, N)
    assert ints(loaded.commit_mont(mont(coeffs))) == lincomb(srs.powers_of_x, coeffs)


def test_msm_entry_points(srs, engine, monkeypatch):
    """msm_variable_base through both routes, jac_fold_sum at an odd width
    (raw limbs equal to the JAX package's halving order on the plain add)
    and at width 0 (the identity), msm_mont, commit_many_mont and
    precomp_for."""
    x, y = C.points_to_device(srs.powers_of_x, "cpu")
    m = 16
    coeffs = random_coeffs(16, m)
    want = lincomb(srs.powers_of_x[:m], coeffs)
    bases = (x[:, :m], y[:, :m])
    assert jac_ints(C.msm_variable_base(bases, mont(coeffs))) == want
    routes = []
    monkeypatch.setattr(msm3, "msm_fixed_affine16",
                        counting(msm3.msm_fixed_affine16, routes))
    monkeypatch.setattr(C.FixedBaseMSM, "_MSM3_MIN", m)
    assert jac_ints(C.msm_variable_base(bases, mont(coeffs))) == want
    assert len(routes) == 1
    monkeypatch.undo()

    w = 37
    pts = C.jac_from_affine(x[:, :w], y[:, :w])
    acc = None
    for p in srs.powers_of_x[:w]:
        acc = pt_add(acc, jax_g1(p))
    got = C.jac_fold_sum(pts)
    assert jac_ints(got) == ints(acc)
    ref = tuple(torch.cat([c, i], dim=-1) for c, i in zip(pts, C.jac_identity((64 - w,), "cpu")))
    while ref[0].shape[-1] > 1:
        ref = cuda_mont.jac_add_plain(tuple(c[:, 0::2] for c in ref), tuple(c[:, 1::2] for c in ref))
    assert all(torch.equal(g, r[:, 0]) for g, r in zip(got, ref))
    empty = C.jac_fold_sum(tuple(c[:, :0] for c in pts))  # the JAX package: one identity
    assert C.jac_to_affine_host(empty) is None
    assert all(torch.equal(e, i) for e, i in zip(empty, C.jac_identity((), "cpu")))

    part = random_coeffs(24, 24)
    assert jac_ints(engine.msm_mont(mont(part))) == lincomb(srs.powers_of_x, part)
    many = [random_coeffs(s, 8) for s in (1, 2)]
    stacked = torch.stack([mont(c) for c in many], dim=1)  # [16, 2, 8]
    assert [ints(p) for p in engine.commit_many_mont(stacked)] == [
        lincomb(srs.powers_of_x, c) for c in many]
    X, Y, Z = engine.precomp_for(16)
    assert X.shape == (16, 32 * 16) and torch.equal(fq.canon(Z), fq.canon(fq.full("ONE_MONT", Z)))
    for win, i in ((0, 3), (1, 15), (31, 7)):
        col = win * 16 + i
        pt = (X[:, col:col + 1], Y[:, col:col + 1], Z[:, col:col + 1])
        assert jac_ints(pt) == ints(pt_mul(G1, (pow(TAU, i, FR_MOD) << (8 * win)) % FR_MOD))


def test_poly_and_prover_helpers(srs, monkeypatch):
    """Polynomial.shift against the JAX package's (jnp.roll), and
    to_coset_extended_lagrange, fft_expand, expanded_evals_to_coeffs and
    rlc against Python-integer oracles at n = 8, on the challenges a proof
    leaves on the prover (one per proof; a batch of two is refused)."""
    import jax.numpy as jnp

    from plonkathon_tpu.poly import Basis as JaxBasis
    from plonkathon_tpu.poly import Polynomial as JaxPolynomial

    n = 8
    rng = random.Random(6)
    vals = [rng.randrange(FR_MOD) for _ in range(n)]
    other = [rng.randrange(FR_MOD) for _ in range(n)]
    p = Polynomial(vals, Basis.LAGRANGE, device="cpu")
    theirs = JaxPolynomial(jnp.asarray(p.values.numpy().astype(np.uint32)), JaxBasis.LAGRANGE)
    for k in (1, 3, -2):
        assert np.array_equal(p.shift(k).values.numpy(), np.asarray(theirs.shift(k).values))
    with pytest.raises(ValueError):
        p.ifft().shift(1)

    w = pow(5, (FR_MOD - 1) // n, FR_MOD)
    coeffs = [sum(v * pow(w, -i * j, FR_MOD) for i, v in enumerate(vals)) * pow(n, -1, FR_MOD)
              % FR_MOD for j in range(n)]
    q = pow(5, (FR_MOD - 1) // (4 * n), FR_MOD)

    def coset_values(offset):
        out = []
        for i in range(4 * n):
            x, acc = offset * pow(q, i, FR_MOD) % FR_MOD, 0
            for c in reversed(coeffs):
                acc = (acc * x + c) % FR_MOD
            out.append(acc)
        return out

    offset = 7
    assert p.to_coset_extended_lagrange(offset).to_ints() == coset_values(offset)

    program = Program(["e public", "c <== a * b", "e <== c * d"], n, device="cpu")
    prover = Prover(srs, program, device="cpu")
    beta, gamma, cofactor = 11, 13, 17
    prover.beta, prover.gamma, prover.fft_cofactor = (Fr(beta),), (Fr(gamma),), (Fr(cofactor),)
    big = prover.fft_expand(p)
    assert big.basis == Basis.LAGRANGE and big.to_ints() == coset_values(cofactor)
    back = prover.expanded_evals_to_coeffs(big)
    assert back.basis == Basis.MONOMIAL and back.to_ints() == coeffs + [0] * (3 * n)
    t2 = Polynomial(other, Basis.LAGRANGE, device="cpu")
    assert prover.rlc(p, t2).to_ints() == [
        (a + b * beta + gamma) % FR_MOD for a, b in zip(vals, other)]
    assert prover.rlc(Fr(2), Fr(3)) == Fr(2 + 3 * beta + gamma)
    prover.fft_cofactor = (Fr(cofactor), Fr(cofactor))
    with pytest.raises(ValueError):
        prover.fft_expand(p)
