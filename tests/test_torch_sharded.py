"""The port's length-sharded commits, rounds and provers (parallel/sharded.py,
Prover and BatchProver with a mesh) on spawned CPU ranks over Gloo, D = 2.

* MeshMSM(engine, mesh, axis) against the host ec_lincomb (commit_batch
  and msm_mont, through msm2, and through msm3 on a second engine whose
  threshold is lowered; msm_mont on engines of 67 and 1 points, whose
  blocks are uneven or empty; with a cache prefix, one table file a rank,
  loaded by a second engine), sharded_msm against the same commit and over
  identity bases;
* sharded_round2 ... sharded_round5 against the single-device rounds on the
  same transcript state (the turbo + lookup circuit at n = 16), equal after
  canon;
* the fixture circuit proves proof.pickle field for field through the
  sharded rounds; the turbo + lookup circuit at n = 16 equals its
  single-device proof and the JAX package's host verifier accepts it; a
  ZK-blinded circuit with a mesh takes the single-device rounds (no
  collective) and equals the unsharded proof under one seeded blinder
  stream; BatchProver(mesh=...) shards a batch of 2 over 2 ranks.

The D = 2 rank functions share one spawn of two ranks (run_rank_group); the
fixture proof at D = 4 is slow.  The sharded transforms and the
collectives are in tests/test_torch_collectives.py.
"""

import pickle
import random
import secrets

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup
from plonkathon_tpu_torch.config import ProverConfig
from plonkathon_tpu_torch.ops import cuda_lib
from plonkathon_tpu_torch.parallel.mesh import Mesh

from _torch_dist_worker import (
    PTAU, batch_rank, fixture_rank, mesh_msm_rank, raise_for, rounds_rank, run_rank_group,
    run_ranks, turbo_lookup_rank,
)
from _torch_jax_bridge import jax_proof, jax_vk

torch.set_num_threads(1)  # small tensors: threads only contend with xdist


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """What each D = 2 rank function raised on one group of 2, and the
    directory it wrote to."""
    out = tmp_path_factory.mktemp("two_ranks")
    calls = {
        "mesh_msm": (mesh_msm_rank, (str(out / "srs"),)),
        "rounds": (rounds_rank, ()),
        "fixture": (fixture_rank, (8,)),
        "turbo_lookup": (turbo_lookup_rank, (str(out),)),
        "batch": (batch_rank, ()),
    }
    return run_rank_group(calls, 2, out), out


def test_mesh_msm(two_ranks):
    raise_for(two_ranks[0], "mesh_msm")


def test_sharded_rounds_match_single_device(two_ranks):
    raise_for(two_ranks[0], "rounds")


@pytest.mark.parametrize(
    "world,n", [(2, 8), pytest.param(4, 16, marks=pytest.mark.slow)], ids=["D2", "D4"]
)
def test_sharded_fixture_proof(request, tmp_path, world, n):
    if world == 2:
        raise_for(request.getfixturevalue("two_ranks")[0], "fixture")
    else:
        run_ranks(fixture_rank, world, tmp_path, n)


def test_sharded_turbo_lookup_proof(two_ranks):
    results, out = two_ranks
    raise_for(results, "turbo_lookup")
    with open(out / "turbo_lookup.pickle", "rb") as f:
        vk, proof = pickle.load(f)
    assert jax_vk(vk).verify_proof(16, jax_proof(proof), [])


def test_blinded_circuit_takes_the_single_device_path(monkeypatch):
    """No process group here: a collective would raise."""
    setup = Setup.from_file(PTAU, device="cpu")
    program = Program(["e public", "c <== a * b", "e <== c * d"], 16, blinding_rows=3, device="cpu")
    mesh = Mesh({"shard": (None, 2, 0)}, "cpu")
    witness = {"a": 3, "b": 4, "c": 12, "d": 5, "e": 60}
    flats = []
    cuda_lib.reset_launches()
    for config in (ProverConfig(mesh=mesh), ProverConfig()):
        stream = random.Random(20261020)
        monkeypatch.setattr(secrets, "randbelow", lambda bound: stream.randrange(bound))
        prover = Prover(setup, program, config=config, device="cpu")
        assert not prover._sharded
        flats.append(prover.prove(dict(witness)).flatten())
    assert flats[0] == flats[1]
    assert cuda_lib.COLLECTIVES == {"all_to_all": 0, "all_gather": 0}


def test_batch_prover_with_a_mesh(two_ranks):
    raise_for(two_ranks[0], "batch")
