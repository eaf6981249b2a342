"""The port's FieldOps against the JAX package's (CPU).

FieldOps (fr, fq) against plonkathon_tpu.ops.limbs.fr/fq in raw limbs.
Inputs come from numpy.random.default_rng; comparisons are exact.  No JAX
round kernel is compiled.  The inversions and predicates are in
tests/test_torch_extension_algebra.py, with the rest of the port's limb
algebra against the JAX package's (PERF.md, "Tier-1 queue", says why).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonkathon_tpu.ops import limbs as JL
from plonkathon_tpu_torch.ops.limbs import fq, fr, encode_ints

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

PAIRS = {"fr": (fr, JL.fr), "fq": (fq, JL.fq)}


def _rand(rng, ops, w):
    """Lazy-domain [0, 2p) limbs int32[16, w]; lanes 0-2 are 0, p-1, 2p-1."""
    limbs = rng.integers(0, 1 << 16, size=(16, w), dtype=np.int64)
    limbs[15] = rng.integers(0, int(ops.P2[15]), size=w)
    p = ops.modulus
    edges = encode_ints([0, p - 1, 2 * p - 1])[:, :w]
    limbs[:, : edges.shape[1]] = edges
    return torch.from_numpy(limbs.astype(np.int32))


def _j(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _raw_equal(got, want):
    return np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_fieldops_match_jax_raw_limbs(field):
    ours, theirs = PAIRS[field]
    rng = np.random.default_rng(100)
    a, b = _rand(rng, ours, 64), _rand(rng, ours, 64)
    for op in ("add", "sub", "mul"):
        got, want = getattr(ours, op)(a, b), getattr(theirs, op)(_j(a), _j(b))
        assert _raw_equal(got, want), op
    for op in ("neg", "canon", "to_mont", "from_mont"):
        assert _raw_equal(getattr(ours, op)(a), getattr(theirs, op)(_j(a))), op


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_fieldops_broadcast_scalar_like_jax(field):
    """A [16, 1] scalar against [16, n] broadcasts as jnp.broadcast_arrays."""
    ours, theirs = PAIRS[field]
    rng = np.random.default_rng(101)
    a, s = _rand(rng, ours, 16), _rand(rng, ours, 1)
    assert _raw_equal(ours.mul(s, a), theirs.mul(_j(s), _j(a)))
    assert _raw_equal(ours.sub(s, a), theirs.sub(_j(s), _j(a)))
