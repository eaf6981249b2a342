"""The port's four-step NTT against the JAX package's and against the
port's own Stockham transform (CPU).

`ntt_fourstep` of both packages is called directly at a small n (the JAX
one, plain jnp limb ops and no round kernel, under one `jax.jit` a
direction: one XLA:CPU compile of the whole transform costs ~9 s where
compiling each limb op on its own cost ~60 s; n = 32 so that the two
passes have unequal lengths, 4 and 8); at n = 2^8
the port's batched and unbatched transforms are compared; at n = 2^14,
where `ntt()` starts to route to it, the port's two transforms are held
against each other.  All comparisons are exact, after canon.
"""

import jax
import numpy as np
import pytest
import torch

from plonkathon_tpu.ops import limbs as JL
from plonkathon_tpu.ops import ntt_fourstep as JF
from plonkathon_tpu_torch.ops import ntt as TN, ntt_fourstep as TF
from plonkathon_tpu_torch.ops.limbs import fr

from test_torch_fieldops import _j, _rand, _raw_equal

torch.set_num_threads(1)  # small tensors: threads only contend with xdist


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_matches_jax(inverse):
    """One shape for both directions, a [16, 2, 32] stack with an unequal
    split (n1 = 4, n2 = 8); the JAX transform and its canon compile as one
    function, and that is most of this test's time."""
    n = 32
    assert TF._split(n) == JF._split(n) == (4, 8)
    v = _rand(np.random.default_rng(110), fr, 2 * n).reshape(16, 2, n)
    got = fr.canon(TF.ntt_fourstep(v, n, inverse))
    want = jax.jit(lambda x: JL.fr.canon(JF.ntt_fourstep(x, n, inverse)))(_j(v))
    assert _raw_equal(got, want)


def test_fourstep_keeps_batch_axes():
    """A [16, A, B, n] stack transforms row by row, as the unbatched call
    does, in both directions."""
    v = _rand(np.random.default_rng(112), fr, 6 * 256).reshape(16, 2, 3, 256)
    for inverse in (False, True):
        got = TF.ntt_fourstep(v, 256, inverse)
        assert got.shape == v.shape
        for i in range(2):
            for j in range(3):
                row = TF.ntt_fourstep(v[:, i, j].contiguous(), 256, inverse)
                assert torch.equal(got[:, i, j], row)
                assert torch.equal(
                    fr.canon(row), fr.canon(TN._ntt_stockham(v[:, i, j].contiguous(), inverse)))


def test_split_and_twiddle_table():
    assert [TF._split(1 << b) for b in (7, 8, 14, 20)] == [
        (8, 16), (16, 16), (128, 128), (1024, 1024)]
    tw = TF._twiddle_table(128, 8, 16, False, "cpu")
    w = TN._root_host(128, False)
    want = [[pow(w, j1 * k2, fr.modulus) for j1 in range(8)] for k2 in range(16)]
    assert np.array_equal(
        np.array(fr.from_mont_host_many(tw), dtype=object).reshape(16, 8), np.array(want, dtype=object))


def test_ntt_routes_large_transforms_to_fourstep(monkeypatch):
    """n >= 2^14 takes the four-step route, smaller n the Stockham one, on
    CPU tensors too."""
    assert TN._FOURSTEP_MIN == 1 << 14
    calls = []
    monkeypatch.setattr(TF, "ntt_fourstep", lambda v, n, inv: calls.append((n, inv)) or v)
    lo = torch.zeros((16, (1 << 14) // 2), dtype=torch.int32)
    hi = torch.zeros((16, 2, 1 << 14), dtype=torch.int32)
    TN.ntt(lo)
    assert calls == []
    TN.ntt(hi, inverse=True)
    assert calls == [(1 << 14, True)]


def test_fourstep_equals_stockham_at_the_threshold():
    n = TN._FOURSTEP_MIN
    v = _rand(np.random.default_rng(113), fr, n)
    fwd = TN.ntt(v)
    assert torch.equal(fr.canon(fwd), fr.canon(TN._ntt_stockham(v, False)))
    assert torch.equal(fr.canon(TN.ntt(fwd, inverse=True)), fr.canon(v))
