"""Typed configuration for the framework (SURVEY §5.6 counterpart).

The reference exposes no configuration surface at all (constants scattered
through constructors); here the few knobs that matter are collected in one
immutable place.  Library-shaped, not service-shaped: construct and pass, or
use the module default.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProverConfig:
    # Enable the reference's internal invariant checks (gate constraint,
    # grand-product closure, quotient degree, T split, R(zeta)=0, W degrees).
    debug_checks: bool = False
    # Record per-round wall-clock timings into Prover.timings.
    profile: bool = False
    # Device mesh for length-sharded proving (parallel/mesh.py's Mesh: every
    # NTT, the grand product, the openings and the commits of a proof run
    # across the ranks of its `mesh_axis`).  None = single device.
    mesh: object = None
    mesh_axis: str = "shard"

    def __post_init__(self):
        from .parallel.mesh import Mesh

        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(
                f"ProverConfig.mesh takes a plonkathon_tpu_torch.parallel.mesh.Mesh, "
                f"not {type(self.mesh).__name__}"
            )


@dataclass(frozen=True)
class MeshConfig:
    axis: str = "shard"
    n_devices: int | None = None  # None = all visible devices


DEFAULT_PROVER = ProverConfig()
DEFAULT_MESH = MeshConfig()
