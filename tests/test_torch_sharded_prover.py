"""The port's Prover and BatchProver with a mesh (CPU, Gloo, spawned
ranks): the fixture circuit at D = 2 proves proof.pickle field for field
through the sharded rounds; the turbo + lookup circuit at n = 16 equals
its single-device proof and the JAX package's host verifier accepts it;
a ZK-blinded circuit with a mesh takes the single-device rounds (no
collective) and equals the unsharded proof under one seeded blinder
stream; BatchProver(mesh=...) shards a batch of 2 over 2 ranks.  D = 4 is
slow.
"""

import os
import pickle
import random
import secrets

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup
from plonkathon_tpu_torch.config import ProverConfig
from plonkathon_tpu_torch.ops import cuda_lib
from plonkathon_tpu_torch.parallel.mesh import Mesh

from _torch_dist_worker import PTAU, batch_rank, fixture_rank, run_ranks, turbo_lookup_rank
from _torch_jax_bridge import jax_proof, jax_vk

torch.set_num_threads(1)  # small tensors: threads only contend with xdist


@pytest.mark.parametrize(
    "world,n", [(2, 8), pytest.param(4, 16, marks=pytest.mark.slow)], ids=["D2", "D4"]
)
def test_sharded_fixture_proof(tmp_path, world, n):
    run_ranks(fixture_rank, world, tmp_path, n)


def test_sharded_turbo_lookup_proof(tmp_path):
    run_ranks(turbo_lookup_rank, 2, tmp_path, str(tmp_path))
    with open(tmp_path / "turbo_lookup.pickle", "rb") as f:
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


def test_batch_prover_with_a_mesh(tmp_path):
    run_ranks(batch_rank, 2, tmp_path)
