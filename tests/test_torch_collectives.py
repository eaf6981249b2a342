"""The port's mesh collectives and meshes (parallel/mesh.py,
parallel/distributed.py) on spawned CPU ranks over Gloo: the tiled
all_to_all for the (split, concat) pairs of the sharded rounds and their
reverses, all_gather, its tiled form, the ring shift and the object
gather, each against numpy on one seeded global array, at D = 2 and D = 4;
process_count without a process group; make_mesh over part of the world,
make_global_mesh over all of it and make_hybrid_mesh shaped (1, world) on
one host.
"""

import pytest
import torch

from plonkathon_tpu_torch.parallel.distributed import process_count

from _torch_dist_worker import collectives_rank, meshes_rank, run_ranks


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_against_numpy(tmp_path, world):
    run_ranks(collectives_rank, world, tmp_path)


def test_process_count_without_a_group():
    assert not torch.distributed.is_initialized()
    assert process_count() == 1


def test_global_and_hybrid_meshes(tmp_path):
    run_ranks(meshes_rank, 2, tmp_path)
