"""The port's mesh collectives, meshes and sharded transforms
(parallel/mesh.py, parallel/distributed.py, parallel/sharded.py) on spawned
CPU ranks over Gloo: the tiled all_to_all for the (split, concat) pairs of
the sharded rounds and their reverses, all_gather, its tiled form, the ring
shift and the object gather, each against numpy on one seeded global array,
at D = 2 and D = 4; process_count without a process group; make_mesh over
part of the world, make_global_mesh over all of it and make_hybrid_mesh
shaped (1, world) on one host; sharded_ntt and sharded_intt at D = 2
against the port's single-device ntt, after canon; and the one direct JAX
comparison: the port's sharded_ntt against the JAX package's on
make_mesh(2) of the virtual CPU mesh, same input, same permuted layout.
The D = 2 functions share one spawn of ranks (run_rank_group).
"""

import json

import numpy as np
import pytest
import torch

from plonkathon_tpu_torch.parallel.distributed import process_count

from _torch_dist_worker import (
    NTT_N1, NTT_N2, collectives_rank, meshes_rank, ntt_matrix, ntt_rank, raise_for,
    run_rank_group, run_ranks,
)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """What each D = 2 rank function raised on one group of 2, and the
    directory it wrote to."""
    out = tmp_path_factory.mktemp("two_ranks")
    calls = {
        "collectives": (collectives_rank, ()),
        "meshes": (meshes_rank, ()),
        "ntt": (ntt_rank, (str(out),)),
    }
    return run_rank_group(calls, 2, out), out


@pytest.fixture(scope="module")
def sharded_ntt_out(two_ranks):
    """Rank 0's forward output of the sharded transform, as integers in
    natural order X[k]."""
    results, out = two_ranks
    raise_for(results, "ntt")
    with open(out / "sharded_ntt.json") as f:
        return json.load(f)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_against_numpy(request, tmp_path, world):
    if world == 2:
        raise_for(request.getfixturevalue("two_ranks")[0], "collectives")
    else:
        run_ranks(collectives_rank, world, tmp_path)


def test_process_count_without_a_group():
    assert not torch.distributed.is_initialized()
    assert process_count() == 1


def test_global_and_hybrid_meshes(two_ranks):
    raise_for(two_ranks[0], "meshes")


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
