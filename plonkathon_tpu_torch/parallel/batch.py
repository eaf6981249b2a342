"""Batch proving: B independent proofs of one circuit at once.

Counterpart of the JAX package's `parallel/batch.py`, whose round kernels
are the single prover's, vmapped over a leading batch axis.  Here the
single prover's rounds carry that axis themselves (`Prover._prove_batch`;
`Prover.prove` is its B = 1 case), so B proofs cost one set of kernel
launches per round: the Montgomery-product and butterfly launches grow in
width, not in number.  All B x count polynomials of a round go through one
`commit_batch` (one host fetch); the Fiat-Shamir transcripts stay per
proof on the host.  Each proof equals, field for field, what
`Prover.prove` gives for its witness.

Not covered, as in the JAX package: ZK blinding rows and PlonKup lookups
(ValueError).

With a mesh (parallel/mesh.py), the batch axis is sharded over the mesh
axis as the JAX package shards it: each rank proves a contiguous block of
B / D witnesses with the single-device rounds on its own device (no
exchange between proofs), and the proofs are all-gathered, so every rank
returns all B, in order.  B must be a multiple of D: the JAX package's
`device_put` of a batch of 3 onto 8 devices raises ValueError, and so does
this.
"""

from __future__ import annotations

from ..frontend import Program
from ..kzg import Setup
from ..prover import Proof, Prover
from .mesh import Mesh, all_gather_object


class BatchProver:
    """Proves B witnesses of one circuit per call, one set of launches per
    round, on the setup's device."""

    def __init__(self, setup: Setup, program: Program, mesh=None, axis="shard"):
        if program.blinding_rows:
            # The JAX package's batch rounds leave the reserved rows zero and
            # add no Z_H-multiple to Z, so it refuses ZK-configured circuits
            # rather than give verifying but unblinded proofs; so does this.
            raise ValueError(
                "BatchProver does not implement ZK blinding; use Prover for "
                "circuits with blinding_rows > 0"
            )
        if program.has_lookups:
            # The JAX package's batch rounds carry only the 15-row vanilla
            # stack: its proofs would omit the lookup argument.
            raise ValueError(
                "BatchProver does not implement PlonKup lookups; use Prover "
                "for circuits with lookup rows"
            )
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"BatchProver's mesh takes a plonkathon_tpu_torch.parallel.mesh.Mesh, "
                f"not {type(mesh).__name__}"
            )
        self.mesh, self.axis = mesh, axis
        self.setup = setup
        self.program = program
        self.group_order = program.group_order
        self._prover = Prover(setup, program, device=setup.device)
        self.pk = self._prover.pk

    def prove_batch(self, witnesses: list[dict]) -> list[Proof]:
        if self.mesh is None:
            return self._prover._prove_batch(witnesses)
        d = self.mesh.shape[self.axis]
        if len(witnesses) % d:
            raise ValueError(
                f"a batch of {len(witnesses)} does not shard over {d} ranks: B must be "
                f"a multiple of the mesh axis {self.axis!r}"
            )
        block = len(witnesses) // d
        start = self.mesh.index(self.axis) * block
        mine = self._prover._prove_batch(witnesses[start : start + block])
        return [p for proofs in all_gather_object(mine, self.mesh, self.axis) for p in proofs]
