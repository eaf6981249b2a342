"""The plain versions of the field kernels K1 and K2 against the bodies of
the TPU kernels they replace (CPU).

Each plain torch version is held against the body of the Pallas kernel,
called as a plain jnp function on lists of limb arrays (as
tests/test_pallas_cols.py calls `_carry` / `_mul_cols`):

  K1 mont_mul      <-> pallas_mont.KR/KQ.mul and .sqr
  K2 dif_butterfly <-> KR.add(c0, c1), KR.mul(KR.sub(c0, c1), tw)

and the lazy-domain add/sub/canon that csrc/field.cuh mirrors against
KR/KQ.add/.sub/.canon.  Inputs come from numpy.random.default_rng and are
compared in raw limbs, exactly: every operation is a unique function of its
inputs' limbs.  Edge lanes: 0, p-1, 2p-1.  The point kernels are in
test_torch_point_kernels.py, the kernels on a card in
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonkathon_tpu.ops import pallas_mont as PM
from plonkathon_tpu_torch.ops import cuda_mont as CM
from plonkathon_tpu_torch.ops.limbs import fq, fr

from test_torch_kernels_cuda import rand_limbs

FIELDS = {"fr": (fr, PM.KR), "fq": (fq, PM.KQ)}


def jl(t):
    """torch int32[16, w] -> the kernel bodies' list of 16 uint32 arrays."""
    a = t.cpu().numpy().astype(np.uint32)
    return [jnp.asarray(a[i]) for i in range(a.shape[0])]


def assert_raw_equal(got, want_list):
    want = np.stack([np.asarray(x) for x in want_list]).astype(np.uint32)
    assert np.array_equal(got.cpu().numpy().astype(np.uint32), want)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_k1_mont_mul_plain_matches_kernel_body(field):
    ops, K = FIELDS[field]
    rng = np.random.default_rng(1)
    a, b = rand_limbs(rng, ops), rand_limbs(rng, ops)
    b[:, :3] = b[:, 2:3]  # edge lanes against 2p - 1
    assert_raw_equal(CM.mont_mul_plain(field, a, b), K.mul(jl(a), jl(b)))
    # The wrapper on a CPU tensor is the plain version.
    assert_raw_equal(CM.mont_mul(field, a, b), K.mul(jl(a), jl(b)))
    # Squaring goes through the same product.
    assert_raw_equal(ops.sqr(a), K.sqr(jl(a)))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_lazy_add_sub_canon_match_kernel_body(field):
    """The lazy-domain add/sub/canon that field.cuh mirrors."""
    ops, K = FIELDS[field]
    rng = np.random.default_rng(3)
    a, b = rand_limbs(rng, ops), rand_limbs(rng, ops)
    assert_raw_equal(ops.add(a, b), K.add(jl(a), jl(b)))
    assert_raw_equal(ops.sub(a, b), K.sub(jl(a), jl(b)))
    assert_raw_equal(ops.sub(b, a), K.sub(jl(b), jl(a)))
    assert_raw_equal(ops.canon(a), K.canon(jl(a)))


def test_k2_dif_butterfly_plain_matches_kernel_body():
    rng = np.random.default_rng(4)
    c0, c1, tw = (rand_limbs(rng, fr) for _ in range(3))
    s, d = CM.dif_butterfly_plain(c0, c1, tw)
    K = PM.KR
    assert_raw_equal(s, K.add(jl(c0), jl(c1)))
    assert_raw_equal(d, K.mul(K.sub(jl(c0), jl(c1)), jl(tw)))


def test_k2_broadcast_twiddle():
    """A [16, l, 1] twiddle broadcasts against [16, l, m] halves, as in
    every Stockham stage."""
    rng = np.random.default_rng(5)
    c0 = rand_limbs(rng, fr, 24).reshape(16, 6, 4)
    c1 = rand_limbs(rng, fr, 24).reshape(16, 6, 4)
    tw = rand_limbs(rng, fr, 6).reshape(16, 6, 1)
    s, d = CM.dif_butterfly(c0, c1, tw)
    s2, d2 = CM.dif_butterfly_plain(c0, c1, tw.expand(16, 6, 4).contiguous())
    assert torch.equal(s, s2) and torch.equal(d, d2)
