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
(ValueError).  A device mesh (the JAX package shards the batch axis over
one) arrives with torch.distributed, ROADMAP Queue 1, item 6.
"""

from __future__ import annotations

from ..frontend import Program
from ..kzg import Setup
from ..prover import Proof, Prover


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
        if mesh is not None:
            raise NotImplementedError(
                f"a batch sharded over a device mesh (axis {axis!r}) arrives with "
                "torch.distributed (ROADMAP Queue 1, item 6)"
            )
        self.setup = setup
        self.program = program
        self.group_order = program.group_order
        self._prover = Prover(setup, program, device=setup.device)
        self.pk = self._prover.pk

    def prove_batch(self, witnesses: list[dict]) -> list[Proof]:
        return self._prover._prove_batch(witnesses)
