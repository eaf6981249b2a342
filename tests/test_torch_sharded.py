"""The port's length-sharded pieces (parallel/sharded.py) on spawned CPU
ranks over Gloo, D = 2: sharded_ntt and sharded_intt against the port's
single-device ntt, MeshMSM(engine, mesh, axis) against the host ec_lincomb
(commit_batch and msm_mont, through msm2, and through msm3 on a second engine
whose threshold is lowered; msm_mont on engines of 67 and 1 points, whose
blocks are uneven or empty; with a cache prefix, one table file a rank,
loaded by a second engine), sharded_msm against the same commit and over
identity bases, sharded_round2 ... sharded_round5 against the
single-device rounds on the same transcript state (the turbo + lookup
circuit at n = 16), all equal after canon; and the one direct JAX
comparison: the port's sharded_ntt against the JAX package's on
make_mesh(2) of the virtual CPU mesh, same input, same permuted layout.
"""

import json

import numpy as np
import pytest

from _torch_dist_worker import (
    NTT_N1, NTT_N2, mesh_msm_rank, ntt_matrix, ntt_rank, rounds_rank, run_ranks,
)


@pytest.fixture(scope="module")
def sharded_ntt_out(tmp_path_factory):
    """The ranks' checks of the sharded transforms; rank 0's forward
    output, as integers in natural order X[k]."""
    out = tmp_path_factory.mktemp("ntt")
    run_ranks(ntt_rank, 2, out, str(out))
    with open(out / "sharded_ntt.json") as f:
        return json.load(f)


def test_sharded_ntt_and_intt(sharded_ntt_out):
    """The ranks compared both directions and sharded_intt with the
    single-device ntt (ntt_rank); here, that they got to the end."""
    assert len(sharded_ntt_out) == NTT_N1 * NTT_N2


def test_sharded_ntt_matches_jax(sharded_ntt_out):
    import jax.numpy as jnp

    from plonkathon_tpu.parallel.mesh import make_mesh
    from plonkathon_tpu.parallel.sharded import host_matrix_to_vector, sharded_ntt

    mat = jnp.asarray(ntt_matrix().numpy().astype(np.uint32))
    theirs = sharded_ntt(make_mesh(2), "shard", mat)
    assert host_matrix_to_vector(np.asarray(theirs)) == sharded_ntt_out


def test_mesh_msm(tmp_path):
    run_ranks(mesh_msm_rank, 2, tmp_path, str(tmp_path / "srs"))


def test_sharded_rounds_match_single_device(tmp_path):
    run_ranks(rounds_rank, 2, tmp_path)
