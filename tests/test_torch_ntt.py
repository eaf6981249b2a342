"""The port's NTT against the JAX package's (CPU).

The Stockham NTT (forward and inverse), the coset transforms and
barycentric evaluation against plonkathon_tpu.ops.ntt at small n, after
canon.  Inputs come from numpy.random.default_rng; comparisons are exact.
No JAX round kernel is compiled.  The JAX transforms are jitted in their
package; the JAX canon of their outputs runs under one `jax.jit` a shape
(~0.3 s of XLA:CPU compile, where its limb ops one by one took ~2 s).
"""

import jax
import numpy as np
import pytest
import torch

from plonkathon_tpu.ops import limbs as JL
from plonkathon_tpu.ops import ntt as JN
from plonkathon_tpu_torch.fields import FR_MOD
from plonkathon_tpu_torch.ops import ntt as TN
from plonkathon_tpu_torch.ops.limbs import fr

from test_torch_fieldops import _j, _rand, _raw_equal

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

jax_canon = jax.jit(JL.fr.canon)


@pytest.mark.parametrize("n", [8, 256])
def test_ntt_matches_jax(n):
    rng = np.random.default_rng(103 + n)
    v = _rand(rng, fr, n)
    for inverse in (False, True):
        got = fr.canon(TN.ntt(v, inverse=inverse))
        want = jax_canon(JN.ntt(_j(v), inverse=inverse))
        assert _raw_equal(got, want), f"inverse={inverse}"


def test_ntt_batched_roundtrip_and_stage_shapes():
    """A [16, B, n] batch transforms per row and round-trips exactly."""
    rng = np.random.default_rng(104)
    v = _rand(rng, fr, 3 * 32).reshape(16, 3, 32)
    back = TN.ntt(TN.ntt(v), inverse=True)
    assert torch.equal(fr.canon(back), fr.canon(v))
    for i in range(3):
        assert torch.equal(TN.ntt(v)[:, i], TN.ntt(v[:, i].contiguous()))


def test_coset_extend_matches_jax():
    v = _rand(np.random.default_rng(105), fr, 16)
    off = fr.scalar(7, "cpu")
    assert _raw_equal(
        fr.canon(TN.coset_extend(v, off)), jax_canon(JN.coset_extend(_j(v), _j(off)))
    )


def test_coset_to_coeffs_matches_jax():
    v4 = _rand(np.random.default_rng(106), fr, 64)
    offinv = fr.scalar(pow(7, -1, FR_MOD), "cpu")
    assert _raw_equal(
        fr.canon(TN.coset_to_coeffs(v4, offinv)),
        jax_canon(JN.coset_to_coeffs(_j(v4), _j(offinv))),
    )


def test_barycentric_eval_matches_jax():
    rng = np.random.default_rng(107)
    v = _rand(rng, fr, 16)
    x = fr.scalar(123456789, "cpu")
    got = fr.from_mont_host(TN.barycentric_eval(v, x))
    want = JL.fr.from_mont_host(np.asarray(JN.barycentric_eval(_j(v), _j(x))))
    assert got == want
