"""The plain versions of the point kernels K5, K6, K7, K8a and K8b against
the bodies of the TPU kernels they replace (CPU).

  K5 jadd_stacked  <-> pallas_mont._kern_add(KQ, ...)
  K6 run_scan      <-> a step loop of _kern_madd(KQ, ...) with the identity
                       reset of msm2._scan_kernel
  K7 jac_double_n  <-> repeated _kern_double(KQ, ...)
  K8a jac_add      <-> pallas_mont._jac_add_kernel, the whole body
  K8b jac_madd     <-> pallas_mont._jac_madd_kernel, the whole body

The TPU bodies run as plain jnp functions on lists of limb arrays; results
are compared in raw limbs, exactly.  Edge lanes: the identity, P = Q,
P = -Q and P + Q of real points.
"""

import numpy as np
import torch
import jax.numpy as jnp

from plonkathon_tpu.ops import pallas_mont as PM
from plonkathon_tpu_torch.ops import cuda_mont as CM, msm2 as TM
from plonkathon_tpu_torch.ops.limbs import fq

from test_torch_kernels import assert_raw_equal, jl
from test_torch_kernels_cuda import coords, point_pairs, scan_inputs


def test_k5_jadd_stacked_plain_matches_kern_add():
    a, b = point_pairs(np.random.default_rng(6))
    got = TM.jadd_stacked_plain(a, b)
    want = PM._kern_add(
        PM.KQ, tuple(jl(c) for c in coords(a)), tuple(jl(c) for c in coords(b))
    )
    for g, w in zip(coords(got), want):
        assert_raw_equal(g, w)


def test_k7_jac_double_n_plain_matches_kern_double():
    a, _ = point_pairs(np.random.default_rng(7), 16)
    got = CM.jac_double_n_plain(coords(a), 2)
    want = tuple(jl(c) for c in coords(a))
    for _ in range(2):
        want = PM._kern_double(PM.KQ, want)
    for g, w in zip(got, want):
        assert_raw_equal(g, w)


def test_k6_run_scan_plain_matches_madd_loop():
    d_t, p_t, pts = scan_inputs(np.random.default_rng(8))
    got = TM.run_scan_plain(d_t, p_t, pts)
    K = PM.KQ
    chunks = d_t.shape[1]
    one = [jnp.full((chunks,), np.uint32(v)) for v in PM._FQ_CONST["ONE"]]
    zero = [jnp.zeros((chunks,), jnp.uint32)] * 16
    acc = (one, one, zero)  # msm2._scan_kernel's s == 0 init
    for s in range(d_t.shape[0]):
        fresh = jnp.asarray(d_t[s].numpy() != p_t[s].numpy())
        acc = (K.select(fresh, one, acc[0]), K.select(fresh, one, acc[1]),
               K.select(fresh, zero, acc[2]))
        q = jl(pts[s])
        acc = PM._kern_madd(K, acc, (q[:16], q[16:]))
        for g, w in zip(coords(got[s]), acc):
            assert_raw_equal(g, w)


def test_k6_run_scan_doubles_and_cancels():
    """The crafted chunks reach the doubling and cancellation branches."""
    d_t, p_t, pts = scan_inputs(np.random.default_rng(9))
    out = TM.run_scan_plain(d_t, p_t, pts)
    z = out[:, 32:48]
    assert not bool(fq.is_zero(z[1, :, 0:1]))  # 2P after two steps
    assert bool(fq.is_zero(z[1, :, 1:2]))  # P + (-P) = identity


def _stacked_body(kernel, a, b):
    """Run a stacked-point Pallas kernel body on jnp arrays ([rows, w] refs
    indexed by row, a list as the output ref)."""
    out = [None] * 48
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    kernel(u32(a), u32(b), out)
    return out


def test_k8a_jac_add_plain_matches_kernel_body():
    a, b = point_pairs(np.random.default_rng(25))
    got = CM.jac_add_plain(coords(a), coords(b))
    assert_raw_equal(torch.cat(got), _stacked_body(PM._jac_add_kernel, a, b))
    # The CPU wrapper is the plain version, and broadcasts a single point.
    one = tuple(c[:, 4:5] for c in coords(b))
    for g, w in zip(CM.jac_add(coords(a), one), CM.jac_add_plain(coords(a), one)):
        assert g.shape == (16, a.shape[1]) and torch.equal(g, w)


def test_k8b_jac_madd_plain_matches_kernel_body():
    a, b = point_pairs(np.random.default_rng(26))
    got = CM.jac_madd_plain(coords(a), coords(b)[:2])
    assert_raw_equal(torch.cat(got), _stacked_body(PM._jac_madd_kernel, a, b[:32]))
    for g, w in zip(CM.jac_madd(coords(a), coords(b)[:2]), got):
        assert torch.equal(g, w)
