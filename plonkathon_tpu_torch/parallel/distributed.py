"""Process-group set-up for sharded proving over torch.distributed.

Counterpart of the JAX package's `parallel/distributed.py`.  The port runs
one process per rank (SPMD), started by `torchrun --nproc-per-node=D` or by
hand:

* `init_distributed()` wraps `dist.init_process_group`: with no arguments
  it reads torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
  RANK); explicit arguments serve a manual start.  The backend follows the
  device, NCCL for CUDA and Gloo for the CPU, unless `backend=` says
  otherwise.
* `process_count()` is the world size, 1 without a process group.
* `make_global_mesh()` is the 1-D proving mesh over every rank, ordered by
  host and then by local rank, so that neighbouring shards share a host.
* `make_hybrid_mesh()` is the 2-D ("dcn", "ici") mesh: one row per host,
  one column per rank within a host, each axis with its own sub-groups.

    torchrun --nproc-per-node=D prove.py   # prove.py:
        init_distributed()
        mesh = make_global_mesh()
        proof = Prover(setup, program, config=ProverConfig(mesh=mesh),
                       device=mesh.device).prove(witness)
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ..ops.limbs import resolve_device
from .mesh import Mesh, default_device


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    backend: str | None = None,
) -> None:
    """Join the process group (call once per process).

    coordinator_address: "host:port" of rank 0's store, or an init URL
    ("tcp://...", "file://..."); None reads torchrun's MASTER_ADDR and
    MASTER_PORT.  num_processes / process_id: the world size and this
    process's rank; None reads WORLD_SIZE / RANK.  device: the device this
    rank proves on ("cuda" or "cpu"); it picks the backend, NCCL for CUDA
    and Gloo for the CPU, unless `backend` names one.  On CUDA the rank's
    card (cuda:LOCAL_RANK) becomes the current device."""
    device = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if world is None or rank is None:
        raise ValueError(
            "init_distributed needs the world size and this process's rank: pass "
            "num_processes and process_id, or start under torchrun"
        )
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank))
    if device.type == "cuda":
        torch.cuda.set_device(default_device())


def process_count() -> int:
    """The number of ranks: 1 when no process group was initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _host_ranks() -> list:
    """(host name, local rank) of every rank, in rank order."""
    local = int(os.environ.get("LOCAL_RANK", -1))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (socket.gethostname(), local))
    return out


def _hosts(keys: list) -> list[str]:
    """The hosts in rank order; raises unless the ranks are numbered host
    by host and, within a host, in local-rank order, as torchrun numbers
    them."""
    hosts = []
    for i, (host, local) in enumerate(keys):
        if not hosts or hosts[-1] != host:
            if host in hosts:
                raise ValueError("ranks are not grouped by host: start them with torchrun")
            hosts.append(host)
        elif local < keys[i - 1][1]:
            raise ValueError("ranks are not in local-rank order within a host")
    return hosts


def make_global_mesh(axis: str = "shard", device=None) -> Mesh:
    """1-D mesh over every rank of the world (all hosts), on `device`
    (this rank's card by default).

    Ranks are in host order, then local-rank order, so a length-sharded
    polynomial places neighbouring shards on one host and the four-step
    NTT's all_to_all crosses hosts only for the blocks of other hosts."""
    _hosts(_host_ranks())
    return Mesh({axis: (None, dist.get_world_size(), dist.get_rank())},
                default_device() if device is None else resolve_device(device))


def make_hybrid_mesh(dcn_axis: str = "dcn", ici_axis: str = "ici", device=None) -> Mesh:
    """2-D (hosts, ranks per host) mesh for data parallelism across hosts
    and length sharding within one: BatchProver shards its batch over
    `dcn_axis`, a Prover its polynomials over `ici_axis`.  On one host it
    is (1, world).  Every rank must call it (it creates the sub-groups)."""
    keys = _host_ranks()
    hosts = _hosts(keys)
    world = dist.get_world_size()
    per_host = world // len(hosts)
    if per_host * len(hosts) != world or any(
        sum(h == host for h, _ in keys) != per_host for host in hosts
    ):
        raise ValueError("hosts run different numbers of ranks")
    rank = dist.get_rank()
    h, l = divmod(rank, per_host)
    # new_group is collective: every rank creates every group, in one order.
    ici = [dist.new_group(list(range(i * per_host, (i + 1) * per_host)))
           for i in range(len(hosts))]
    dcn = [dist.new_group(list(range(j, world, per_host))) for j in range(per_host)]
    return Mesh(
        {dcn_axis: (dcn[l], len(hosts), h), ici_axis: (ici[h], per_host, l)},
        default_device() if device is None else resolve_device(device),
    )
