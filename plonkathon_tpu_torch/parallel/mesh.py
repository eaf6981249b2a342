"""Device meshes over torch.distributed process groups, and the collectives
of the sharded prover.

Counterpart of the JAX package's `parallel/mesh.py`.  JAX runs one
controller and `shard_map`s replicated arrays over a `jax.sharding.Mesh`;
the port runs SPMD instead: one process per rank, every rank running the
same code on its own device.  A `Mesh` names, for each of its axes, the
process group along that axis, the group's size and this rank's index in
it, plus this rank's device.

The collectives below stand for the three that the JAX package's
`sharded.py` issues inside `shard_map`:

* `all_to_all`: `jax.lax.all_to_all(x, axis, split_axis, concat_axis,
  tiled=True)`.  `dist.all_to_all_single` splits dim 0 of a contiguous
  tensor only, so the split axis is moved to the front, exchanged, and the
  received chunks are concatenated on the concat axis in rank order.
* `all_gather`: `jax.lax.all_gather` (a new leading axis of size D);
  `gather_axis` is its tiled form, concatenating along one axis.
* `ring_shift`: the `ppermute` d -> d + 1 of the grand product's boundary
  value, as an all_gather of the D values.

The group's backend moves the bytes.  NCCL exchanges CUDA tensors; Gloo
exchanges host tensors, so on a Gloo group a CUDA tensor is copied to the
host for the exchange and back (two ranks sharing one card, where NCCL
refuses).  Each collective adds one to `cuda_lib.COLLECTIVES`, beside the
kernels' launch counts: a "sharded" proof that issued none did not shard.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..ops import cuda_lib
from ..ops.limbs import resolve_device


class Mesh:
    """A named device mesh of this process's rank: `shape[axis]` ranks
    along each axis, this rank at `index(axis)`, computing on `device`."""

    def __init__(self, axes: dict, device):
        """axes: name -> (process group or None for the world, size, this
        rank's index along the axis), in mesh order."""
        self._axes = dict(axes)
        self.axis_names = tuple(self._axes)
        self.shape = {name: size for name, (_, size, _) in self._axes.items()}
        self.device = torch.device(device)

    def group(self, axis: str):
        return self._axes[axis][0]

    def index(self, axis: str) -> int:
        return self._axes[axis][2]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, index {[self.index(a) for a in self.axis_names]}, {self.device})"


def default_device():
    """This rank's card: cuda:LOCAL_RANK (torchrun sets it), else the rank
    modulo the visible cards."""
    if not torch.cuda.is_available():
        return resolve_device("cuda")  # raises: no silent CPU fallback
    local = os.environ.get("LOCAL_RANK")
    rank = dist.get_rank() if dist.is_initialized() else 0
    idx = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


def make_mesh(n_devices: int | None = None, axis: str = "shard", device=None) -> Mesh | None:
    """A 1-D mesh over the first `n_devices` ranks of the initialized world
    (all of them by default), on `device` (this rank's card by default).

    Every rank of the world must call it (a sub-group is created
    collectively); a rank outside the first `n_devices` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call init_distributed()")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if not 1 <= n_devices <= world:
        raise ValueError(f"requested {n_devices} ranks, the world has {world}")
    group = None if n_devices == world else dist.new_group(list(range(n_devices)))
    rank = dist.get_rank()
    if rank >= n_devices:
        return None
    return Mesh({axis: (group, n_devices, rank)},
                default_device() if device is None else resolve_device(device))


def _count(kind: str) -> None:
    cuda_lib.COLLECTIVES[kind] += 1


def _staged(x, group):
    """The contiguous tensor the group's backend exchanges: a host copy of
    a CUDA tensor on a Gloo group, else x itself."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def all_gather(x, mesh: Mesh, axis: str):
    """[D, *x.shape]: every rank's x along the axis, in rank order."""
    _count("all_gather")
    group = mesh.group(axis)
    src = _staged(x, group)
    out = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)


def gather_axis(x, dim: int, mesh: Mesh, axis: str):
    """The ranks' blocks of x concatenated along `dim` in rank order (a
    tiled all_gather): the replicated view of an array sharded on `dim`."""
    return torch.cat(list(all_gather(x, mesh, axis)), dim=dim)


def all_to_all(x, split_axis: int, concat_axis: int, mesh: Mesh, axis: str):
    """`jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`:
    x splits into D equal chunks along `split_axis`, chunk j goes to rank
    j, and the chunks received are concatenated along `concat_axis` in the
    order of the ranks that sent them."""
    _count("all_to_all")
    d = mesh.shape[axis]
    split_axis %= x.ndim
    group = mesh.group(axis)
    front = _staged(x.movedim(split_axis, 0), group)
    if front.shape[0] % d:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split {d} ways")
    recv = torch.empty_like(front)
    dist.all_to_all_single(recv, front, group=group)
    chunks = recv.to(x.device).reshape((d, front.shape[0] // d) + front.shape[1:])
    return torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)


def ring_shift(x, mesh: Mesh, axis: str):
    """The x of the rank before this one along the axis (rank D - 1's for
    rank 0): `ppermute` over the pairs (d, d + 1 mod D)."""
    gathered = all_gather(x, mesh, axis)
    return gathered[(mesh.index(axis) - 1) % mesh.shape[axis]]


def all_gather_object(obj, mesh: Mesh, axis: str) -> list:
    """Every rank's picklable obj along the axis, in rank order."""
    _count("all_gather")
    out = [None] * mesh.shape[axis]
    dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out
