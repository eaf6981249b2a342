"""Spawned ranks for the port's sharded tests (CPU, Gloo).

Not a test module: the rank entry points live here so that a spawned child
can import them (the `spawn` start method pickles a function by its import
path).  Nothing here imports JAX: each rank imports torch and the port.
"""

from __future__ import annotations

import os
import time

import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PTAU = os.path.join(FIXTURES, "powersOfTau28_hez_final_11.ptau")


def _entry(rank: int, world: int, store: str, calls, out_dir: str):
    """Rank `rank`: each fn(mesh, *args) of `calls` in turn on one mesh;
    after the i-th, writes `{out_dir}/{i}.rank{rank}`: empty if it
    returned, else its traceback."""
    import traceback

    import torch

    torch.set_num_threads(1)  # the ranks share the test machine's cores
    from plonkathon_tpu_torch.parallel.distributed import init_distributed
    from plonkathon_tpu_torch.parallel.mesh import make_mesh

    init_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        for i, (fn, args) in enumerate(calls):
            try:
                fn(mesh, *args)
                error = ""
            except BaseException:  # pytest.raises' "DID NOT RAISE" is no Exception
                error = traceback.format_exc()
            path = os.path.join(out_dir, f"{i}.rank{rank}")
            with open(path + ".tmp", "w") as f:
                f.write(error)
            os.replace(path + ".tmp", path)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_rank_group(calls: dict, world: int, tmp_path, timeout: float = 240.0) -> dict:
    """Run each fn(mesh, *args) of `calls` ({name: (fn, args)}), in order,
    on one group of `world` spawned CPU ranks over Gloo (a file store under
    tmp_path): one spawn, so the ranks import torch and meet once.  Each
    function has `timeout` s from the end of the one before it.  Returns
    {name: None where every rank returned, else what the ranks raised
    (their tracebacks) or why the function did not run}."""
    out = os.path.join(str(tmp_path), "rank_results")
    os.makedirs(out)
    names = list(calls)
    store = os.path.join(str(tmp_path), "store")
    ctx = mp.start_processes(_entry, args=(world, store, list(calls.values()), out),
                             nprocs=world, join=False, start_method="spawn")
    files = lambda i: [os.path.join(out, f"{i}.rank{r}") for r in range(world)]  # noqa: E731
    finished, deadline, failure = 0, time.monotonic() + timeout, None
    try:
        while not ctx.join(timeout=1.0):
            while finished < len(names) and all(map(os.path.exists, files(finished))):
                finished, deadline = finished + 1, time.monotonic() + timeout
            if time.monotonic() > deadline:
                what = names[finished] if finished < len(names) else "their exit"
                failure = f"{world} ranks did not finish {what} in {timeout} s"
                break
    except Exception as e:  # a rank died, or raised before or after the functions
        failure = f"{world} ranks ended early: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = {}
    for i, name in enumerate(names):
        if not all(map(os.path.exists, files(i))):
            results[name] = failure or f"{name} did not run"
            continue
        errors = []
        for r, path in enumerate(files(i)):
            with open(path) as f:
                text = f.read()
            if text:
                errors.append(f"rank {r} of {world}:\n{text}")
        results[name] = "\n".join(errors) or None
    return results


def raise_for(results: dict, name: str) -> None:
    """Raise what `name`'s ranks raised (run_rank_group's results)."""
    if results[name] is not None:
        raise AssertionError(f"{name} on spawned ranks:\n{results[name]}")


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0):
    """Run fn(mesh, *args) on `world` spawned CPU ranks over Gloo (a file
    store under tmp_path); raises what a rank raised, or that the ranks did
    not finish in `timeout` s."""
    raise_for(run_rank_group({fn.__name__: (fn, args)}, world, tmp_path, timeout), fn.__name__)


# ---------------------------------------------------------------------------
# Collectives (tests/test_torch_collectives.py).
# ---------------------------------------------------------------------------

# (ndim, split_axis, concat_axis): the four-step exchanges of sharded.py
# ((1, 2) on 3-D blocks, (2, 3) on 4-D ones) and their reverses.
A2A_CASES = ((3, 1, 2), (3, 2, 1), (4, 2, 3), (4, 3, 1))


def _global_blocks(rng, world: int, shape):
    import numpy as np

    return rng.integers(-(2**31), 2**31 - 1, size=(world,) + tuple(shape), dtype=np.int64).astype(np.int32)


def collectives_rank(mesh):
    """Every collective of parallel/mesh.py against numpy on this rank's
    block of one seeded global array."""
    import numpy as np
    import pytest
    import torch

    from plonkathon_tpu_torch.ops import cuda_lib
    from plonkathon_tpu_torch.parallel import mesh as M

    d, r = mesh.shape["shard"], mesh.index("shard")
    rng = np.random.default_rng(20261017)
    cuda_lib.reset_launches()
    for ndim, split, concat in A2A_CASES:
        shape = (3, 2 * d, 4 * d) if ndim == 3 else (3, 5, 2 * d, 4 * d)
        blocks = _global_blocks(rng, d, shape)
        got = M.all_to_all(torch.from_numpy(blocks[r]), split, concat, mesh, "shard")
        want = np.concatenate([np.split(blocks[j], d, axis=split)[r] for j in range(d)], axis=concat)
        assert got.shape == want.shape and np.array_equal(got.numpy(), want), (ndim, split, concat)
    blocks = _global_blocks(rng, d, (16, 3))
    mine = torch.from_numpy(blocks[r])
    assert np.array_equal(M.all_gather(mine, mesh, "shard").numpy(), blocks)
    assert np.array_equal(M.gather_axis(mine, 1, mesh, "shard").numpy(),
                          np.concatenate(list(blocks), axis=1))
    assert np.array_equal(M.ring_shift(mine, mesh, "shard").numpy(), blocks[(r - 1) % d])
    assert M.all_gather_object({"rank": r}, mesh, "shard") == [{"rank": j} for j in range(d)]
    assert cuda_lib.COLLECTIVES == {"all_to_all": len(A2A_CASES), "all_gather": 4}, cuda_lib.COLLECTIVES
    with pytest.raises(ValueError, match="does not split"):
        M.all_to_all(torch.zeros(2 * d + 1, 2, dtype=torch.int32), 0, 1, mesh, "shard")


def meshes_rank(mesh):
    """make_mesh over part of the world, make_global_mesh and
    make_hybrid_mesh on one host: their shapes, indices and groups."""
    import torch

    from plonkathon_tpu_torch.parallel import mesh as M
    from plonkathon_tpu_torch.parallel.distributed import (
        make_global_mesh, make_hybrid_mesh, process_count,
    )

    world, r = mesh.shape["shard"], mesh.index("shard")
    assert process_count() == world
    part = M.make_mesh(1, device="cpu")
    assert (part is None) == (r > 0)
    if part is not None:
        assert part.shape == {"shard": 1} and part.index("shard") == 0
    glob = make_global_mesh(device="cpu")
    assert glob.axis_names == ("shard",) and glob.shape == {"shard": world}
    assert glob.index("shard") == r and glob.device == torch.device("cpu")
    hyb = make_hybrid_mesh(device="cpu")
    assert hyb.axis_names == ("dcn", "ici") and hyb.shape == {"dcn": 1, "ici": world}
    assert (hyb.index("dcn"), hyb.index("ici")) == (0, r)
    mine = torch.tensor([r], dtype=torch.int32)
    assert M.all_gather(mine, hyb, "ici").flatten().tolist() == list(range(world))
    assert M.all_gather(mine, hyb, "dcn").flatten().tolist() == [r]


# ---------------------------------------------------------------------------
# Sharded transforms (tests/test_torch_collectives.py), commits and rounds
# (tests/test_torch_sharded.py).
# ---------------------------------------------------------------------------

NTT_N1 = NTT_N2 = 8


def ntt_matrix():
    """The seeded [16, 8, 8] Montgomery input of the sharded-NTT tests
    (canonical values mod r, from numpy), on the host."""
    import numpy as np

    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.parallel.sharded import vector_to_host_matrix

    rng = np.random.default_rng(20261018)
    vec = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(NTT_N1 * NTT_N2)]
    return vector_to_host_matrix(vec, NTT_N1, NTT_N2)


def ntt_rank(mesh, out_dir: str):
    """sharded_ntt (both directions) and sharded_intt against the port's
    single-device ntt, after canon; rank 0 writes the forward output's
    integers for the JAX comparison."""
    import json

    import torch

    from plonkathon_tpu_torch.ops import ntt as N
    from plonkathon_tpu_torch.ops.limbs import fr
    from plonkathon_tpu_torch.parallel.sharded import host_matrix_to_vector, sharded_intt, sharded_ntt

    mat = ntt_matrix()
    n1, n2, n = NTT_N1, NTT_N2, NTT_N1 * NTT_N2
    flat = mat.reshape(16, n)  # x[j1 * n2 + j2]
    for inverse in (False, True):
        got = sharded_ntt(mesh, "shard", mat, inverse=inverse)
        want = N.ntt(flat, inverse=inverse).reshape(16, n2, n1).transpose(1, 2)  # X[k1 + n1 k2]
        assert torch.equal(fr.canon(got), fr.canon(want)), f"sharded_ntt inverse={inverse}"
        if not inverse and mesh.index("shard") == 0:
            with open(f"{out_dir}/sharded_ntt.json", "w") as f:
                json.dump(host_matrix_to_vector(got), f)
    stack = torch.stack([flat, fr.mul(flat, flat)], dim=1)  # [16, 2, n]
    got = sharded_intt(mesh, "shard", stack)
    assert torch.equal(fr.canon(got), fr.canon(N.ntt(stack, inverse=True))), "sharded_intt"


def mesh_msm_rank(mesh, prefix):
    """MeshMSM over engines of ceremony powers against the host ec_lincomb.

    Through both routes: MeshMSM(engine, mesh, axis) over an engine of 64
    powers (msm2 at 32 coefficients a rank, its tables cached under
    `prefix`) commits 24 random coefficients (rank 1's slice is all zeros)
    and 64, by `commit_batch` and by `msm_mont`; a second, its ranks' msm3
    threshold lowered to their width, commits the 64 through msm3 both
    ways.  `msm_mont` also on an engine of 67 powers (blocks of 34 and 33)
    and of 1 (rank 1's block is empty); m > n raises.  A third engine on
    the same prefix loads each rank's own table file (a build would
    raise).  sharded_msm over the 64 powers as Jacobian bases (Z = 1) with
    random 8-bit digits equals their host linear combination, and over
    (3G, the identity, 7G, 11G) and a block of four identities with digits
    1..8 equals 3G + 21G + 44G."""
    import os
    import random

    import torch

    from plonkathon_tpu_torch import Setup
    from plonkathon_tpu_torch.ec import G1, ec_lincomb, pt_mul
    from plonkathon_tpu_torch.fields import FR_MOD, Fr
    from plonkathon_tpu_torch.ops import curve, msm2
    from plonkathon_tpu_torch.ops.curve import FixedBaseMSM
    from plonkathon_tpu_torch.ops.limbs import fr, to_device
    from plonkathon_tpu_torch.parallel.sharded import MeshMSM, sharded_msm

    setup = Setup.from_file(PTAU, device="cpu")
    powers = setup.powers_of_x
    rng = random.Random(20261019)
    coeffs = [[rng.randrange(FR_MOD) for _ in range(m)] for m in (24, 64, 67, 1)]
    coeffs[1][0], coeffs[1][-1] = 0, FR_MOD - 1
    polys = [to_device(fr.to_mont_host_many(c), "cpu") for c in coeffs]
    want = [ec_lincomb([(powers[i], Fr(v)) for i, v in enumerate(c)]) for c in coeffs]
    msm2_engine = MeshMSM(FixedBaseMSM(powers[:64], "cpu", cache_path=prefix), mesh, "shard")
    msm3_engine = MeshMSM(FixedBaseMSM(powers[:64], "cpu"), mesh, "shard")
    msm3_engine.engine._MSM3_MIN = 32
    assert msm2_engine.n == 64 and msm2_engine.engine.n == 32
    assert msm2_engine.commit_batch(polys[:2]) == want[:2]
    assert [curve.jac_to_affine_host(msm2_engine.msm_mont(p)) for p in polys[:2]] == want[:2]
    assert msm3_engine.commit_mont(polys[1]) == want[1]
    assert curve.jac_to_affine_host(msm3_engine.msm_mont(polys[1])) == want[1]
    assert msm3_engine.engine._tab16_n == 32 and msm2_engine.engine._tab16_n == 0
    odd = MeshMSM(FixedBaseMSM(powers[:67], "cpu"), mesh, "shard")
    assert odd.engine.n == (34, 33)[mesh.index("shard")]
    assert curve.jac_to_affine_host(odd.msm_mont(polys[2])) == want[2]
    one = MeshMSM(FixedBaseMSM(powers[:1], "cpu"), mesh, "shard")
    assert (one.engine is None) == (mesh.index("shard") == 1)
    assert curve.jac_to_affine_host(one.msm_mont(polys[3])) == want[3]
    try:
        msm2_engine.msm_mont(polys[2])
    except ValueError:
        pass
    else:
        raise AssertionError("a commit of 67 coefficients on 64 points did not raise")

    mine = f"{prefix}.rank{mesh.index('shard')}of2.affine32.npz"
    assert msm2_engine.engine.cache_path == f"{prefix}.rank{mesh.index('shard')}of2"
    assert os.path.exists(mine), mine
    built = msm2.build_affine_tables

    def no_build(*args):
        raise AssertionError("a rank rebuilt tables its cache file holds")

    msm2.build_affine_tables = no_build
    try:
        cached = MeshMSM(FixedBaseMSM(powers[:64], "cpu", cache_path=prefix), mesh, "shard")
        assert cached.commit_mont(polys[1]) == want[1]
    finally:
        msm2.build_affine_tables = built

    digits = [rng.randrange(256) for _ in range(64)]
    bases = curve.jac_from_affine(*curve.points_to_device(powers[:64], "cpu"))
    got = sharded_msm(mesh, "shard", bases, torch.tensor(digits, dtype=torch.int32))
    assert curve.jac_to_affine_host(got) == ec_lincomb(
        [(p, Fr(d)) for p, d in zip(powers, digits)])

    ident = curve.jac_identity((1,), "cpu")
    pts = [curve.jac_from_affine(*curve.points_to_device([pt_mul(G1, k)], "cpu")) for k in (3, 7, 11)]
    lanes = [pts[0], ident, pts[1], pts[2]] + [ident] * 4  # rank 1's block: all identity
    bases = tuple(torch.cat([p[i] for p in lanes], dim=1) for i in range(3))
    got = sharded_msm(mesh, "shard", bases, torch.arange(1, 9, dtype=torch.int32))
    assert curve.jac_to_affine_host(got) == pt_mul(G1, 3 + 21 + 44)


def rounds_rank(mesh):
    """sharded_round2 ... sharded_round5 against the single-device rounds
    on the same transcript state: the turbo + lookup circuit at n = 16
    (cube and lookup rows in the coset stack) proved on one device, its
    rounds' inputs and outputs recorded, and each sharded round run on
    those inputs; equal after canon."""
    import torch

    from plonkathon_tpu_torch import Setup, prover as P
    from plonkathon_tpu_torch.fields import FR_MOD
    from plonkathon_tpu_torch.models.examples import turbo_lookup_program, turbo_lookup_witness
    from plonkathon_tpu_torch.ops import ntt as N
    from plonkathon_tpu_torch.ops.limbs import fr
    from plonkathon_tpu_torch.parallel import sharded as S

    setup = Setup.from_file(PTAU, device="cpu")
    program = turbo_lookup_program(12, 16, table_bits=3, device="cpu")
    prover = P.Prover(setup, program, device="cpu")
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, (args, kwargs, out))
            return out
        return wrapped

    spied = {name: getattr(P, name) for name in
             ("_perm_grand_product", "_barycentric_batch", "_linearization_impl")}
    P._perm_grand_product = spy("r2", P._perm_grand_product)
    P._barycentric_batch = spy("r4", P._barycentric_batch)
    P._linearization_impl = spy("r5", P._linearization_impl)
    single3 = P.Prover._round_3_single

    def round3(self, polys):
        quot, qcoeffs = single3(self, polys)
        seen["r3"] = (polys, quot, qcoeffs, self._bigs, self._xvals)
        return quot, qcoeffs

    P.Prover._round_3_single = round3
    try:  # the rank runs other functions after this one (run_rank_group)
        prover.prove(dict(turbo_lookup_witness(program)))
    finally:
        P.Prover._round_3_single = single3
        for name, fn in spied.items():
            setattr(P, name, fn)

    def same(a, b, what):
        assert torch.equal(fr.canon(a), fr.canon(b)), what

    n, off = 16, prover.fft_cofactor[0]
    col = lambda xs: prover._col(xs)[:, 0]  # noqa: E731
    beta, gamma, alpha = col(prover.beta), col(prover.gamma), col(prover.alpha)
    # Round 2: Z from the wires and sigmas.
    stack = torch.cat([torch.stack([prover.A, prover.B, prover.C], dim=2)[:, 0], prover._sigma_stack], dim=1)
    z, z_last = S.sharded_round2(mesh, "shard", stack, beta, gamma)
    same(z, seen["r2"][2][0][:, 0], "round 2: Z")
    assert fr.from_mont_host(z_last) == 1
    # Round 3: the coset stack, X, QUOT and its coefficients.
    polys, quot, qcoeffs, bigs, xvals = seen["r3"]
    lk = (col(prover.delta), col(prover.epsilon), fr.scalar(prover._t_last, "cpu"))
    r3 = S.sharded_round3(mesh, "shard", polys[:, 0], beta, gamma, alpha, off,
                          custom=True, lookup_scalars=lk)
    same(r3.bigs, bigs[:, 0], "round 3: coset stack")
    same(r3.xvals, xvals[:, 0], "round 3: X")
    same(r3.quot, quot[:, 0], "round 3: QUOT")
    same(r3.qcoeffs, qcoeffs[:, 0], "round 3: coefficients")
    # Round 4: the openings.
    (values, xs, _), _, evs = seen["r4"]
    same(S.sharded_round4(mesh, "shard", values, xs), evs, "round 4: openings")
    # Round 5: R and the opening quotients' coefficients.
    args, kwargs, (r_big, w_z, w_zw) = seen["r5"]
    scalars = [s[:, 0] for s in args[5:]]
    lookup = {k: v[:, 0] for k, v in kwargs["lookup"].items() if v.ndim == 2}
    t_coeffs = qcoeffs[:, 0, : 3 * n].reshape(16, 3, n)
    got_r, got_w = S.sharded_round5(mesh, "shard", r3, t_coeffs, scalars, off, custom=True,
                                    cube_ev=kwargs["cube_ev"][:, 0], lookup_scalars=lookup)
    same(got_r, r_big[:, 0], "round 5: R")
    offinv = fr.scalar(pow(int(off), -1, FR_MOD), "cpu")
    want_w = N.coset_to_coeffs(torch.stack([w_z[:, 0], w_zw[:, 0]], dim=1), offinv[:, None])
    same(got_w, want_w, "round 5: W_z, W_zw coefficients")


# ---------------------------------------------------------------------------
# Sharded proofs (tests/test_torch_sharded.py).
# ---------------------------------------------------------------------------

THREE_GATE = ["e public", "c <== a * b", "e <== c * d"]
FIXTURE_WITNESS = {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}


def fixture_rank(mesh, n: int):
    """The three-gate circuit at group order n proved with the mesh: it
    took the sharded path (collectives issued), and at n = 8 the proof is
    proof.pickle; rank 0 verifies it."""
    from plonkathon_tpu_torch import Program, Prover, Setup, load_proof_pickle
    from plonkathon_tpu_torch.config import ProverConfig
    from plonkathon_tpu_torch.ops import cuda_lib

    setup = Setup.from_file(PTAU, device="cpu")
    program = Program(THREE_GATE, n, device="cpu")
    prover = Prover(setup, program, config=ProverConfig(mesh=mesh), device="cpu")
    assert prover._sharded
    cuda_lib.reset_launches()
    proof = prover.prove(dict(FIXTURE_WITNESS))
    assert cuda_lib.COLLECTIVES["all_to_all"] == 7, cuda_lib.COLLECTIVES
    if n == 8:
        want = load_proof_pickle(os.path.join(FIXTURES, "proof.pickle")).flatten()
    else:
        want = Prover(setup, program, device="cpu").prove(dict(FIXTURE_WITNESS)).flatten()
    assert proof.flatten() == want
    if mesh.index("shard") == 0:
        vk = setup.verification_key(program.common_preprocessed_input())
        assert vk.verify_proof(n, proof, [60])


def turbo_lookup_rank(mesh, out_dir: str):
    """The turbo + lookup circuit at n = 16 proved with the mesh; then
    rank 1 proves it on one device while rank 0 builds the verification
    key, and rank 0 checks the two proofs equal field for field and writes
    the sharded proof and the key (pickles) for the JAX host verifier."""
    import pickle

    from plonkathon_tpu_torch import Prover, Setup
    from plonkathon_tpu_torch.config import ProverConfig
    from plonkathon_tpu_torch.models.examples import turbo_lookup_program, turbo_lookup_witness
    from plonkathon_tpu_torch.ops import cuda_lib
    from plonkathon_tpu_torch.parallel.mesh import all_gather_object

    setup = Setup.from_file(PTAU, device="cpu")
    program = turbo_lookup_program(12, 16, table_bits=3, device="cpu")
    witness = turbo_lookup_witness(program)
    cuda_lib.reset_launches()
    proof = Prover(setup, program, config=ProverConfig(mesh=mesh), device="cpu").prove(dict(witness))
    assert cuda_lib.COLLECTIVES["all_to_all"] > 0
    if mesh.index("shard") == 1:
        single = Prover(setup, program, device="cpu").prove(dict(witness)).flatten()
    else:
        vk = setup.verification_key(program.common_preprocessed_input())
    _, single = all_gather_object(single if mesh.index("shard") == 1 else None, mesh, "shard")
    if mesh.index("shard") == 0:
        assert proof.flatten() == single
        with open(f"{out_dir}/turbo_lookup.pickle", "wb") as f:
            pickle.dump((vk, proof), f)


def batch_rank(mesh):
    """BatchProver(mesh=...) at D = 2 with B = 2 on the fixture circuit:
    every rank returns both proofs, in order; proof 0 is proof.pickle and
    proof 1 the single proof of its witness; a batch of 3 raises."""
    import pytest

    from plonkathon_tpu_torch import Program, Prover, Setup, load_proof_pickle
    from plonkathon_tpu_torch.parallel.batch import BatchProver

    setup = Setup.from_file(PTAU, device="cpu")
    program = Program(THREE_GATE, 8, device="cpu")
    second = {"a": 2, "b": 5, "c": 10, "d": 7, "e": 70}
    batch = BatchProver(setup, program, mesh=mesh)
    proofs = batch.prove_batch([dict(FIXTURE_WITNESS), dict(second)])
    assert len(proofs) == 2
    assert proofs[0].flatten() == load_proof_pickle(os.path.join(FIXTURES, "proof.pickle")).flatten()
    if mesh.index("shard") == 1:  # rank 1 proved witness 1 in the batch
        assert proofs[1].flatten() == Prover(setup, program, device="cpu").prove(dict(second)).flatten()
    with pytest.raises(ValueError, match="multiple"):
        batch.prove_batch([dict(FIXTURE_WITNESS)] * 3)


# ---------------------------------------------------------------------------
# The kernels' build across processes (tests/test_torch_build.py).
# ---------------------------------------------------------------------------

def compile_in_child(build_dir: str, result: str):
    """cuda_lib's build step in this process, into build_dir; writes the
    library path it returned to `result`."""
    from plonkathon_tpu_torch.ops import cuda_lib

    cuda_lib.BUILD_DIR = build_dir
    path = cuda_lib._compile()
    with open(result, "w") as f:
        f.write(path)
