"""msm3's bucket stage on the CPU: the suffix fold and the dense buckets.

`msm3.suffix_fold` (one K5 launch on the card) and `msm3._dense_buckets`
(one K4 launch on the card) take their plain versions for CPU tensors;
these tests hold those routes against oracles that share no code with
them.  The fold's oracle is the JAX package's host curve code
(plonkathon_tpu.ec: plain Python, compiles nothing), compared by integer
coordinates; the dense stage's is a loop over buckets in Python that adds
each bucket's entries one column at a time.  The card-side kernels are held
against the same routes in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu.ec import G1 as JG1, pt_mul as jpt_mul
from plonkathon_tpu.fields import FR_MOD
from plonkathon_tpu_torch.ec import G1, pt_mul
from plonkathon_tpu_torch.ops import msm3
from plonkathon_tpu_torch.ops.curve import jac_to_affine_host
from plonkathon_tpu_torch.ops.limbs import fq, to_device

torch.set_num_threads(1)  # small tensors: threads only contend with xdist


def jac_column(k):
    """[48] Jacobian limbs of k * G with Z = 1; k = 0 gives the identity
    (Z = 0)."""
    if k % FR_MOD == 0:
        one = to_device(fq.to_mont_host(1), "cpu")
        return torch.cat([one, one, torch.zeros_like(one)])
    x, y = (to_device(fq.to_mont_host(int(c)), "cpu") for c in pt_mul(G1, k))
    return torch.cat([x, y, fq.full("ONE_MONT", x)])


@pytest.mark.parametrize("w", [1 << 4, 1 << 6])
def test_suffix_fold_matches_host_oracle(w):
    """Bucket b = i + 1 holds s_b * G with s_b = b, except: every 7th
    bucket from the fourth on is empty (the identity), the two buckets
    that the fold's first up-sweep pair adds are equal (its doubling
    branch), and the next pair is a point and its negation (its
    cancellation branch)."""
    s = [b for b in range(1, w + 1)]
    for i in range(3, w - 4, 7):
        s[i] = 0
    s[w - 1] = s[w - 2]
    s[w - 3] = FR_MOD - s[w - 4]
    dense = torch.stack([jac_column(k) for k in s], dim=1)
    got = msm3.suffix_fold(dense)
    assert got.shape == (48,)
    want = jpt_mul(JG1, sum((i + 1) * k for i, k in enumerate(s)) % FR_MOD)
    pt = jac_to_affine_host(tuple(got[16 * i : 16 * (i + 1)] for i in range(3)))
    assert tuple(int(c) for c in pt) == tuple(int(c) for c in want)


def test_dense_buckets_cpu_route_equals_bucket_loop():
    """Buckets with 0, 1, J and J + 1 entries (maxmult J + 1 reported, the
    (J + 1)-th entry left out), other buckets with 0..3, and the _BIG tail
    of unused slots; random packed points (the incomplete add is plain
    arithmetic on any limbs)."""
    rng = np.random.default_rng(30)
    nb, J = 16, msm3._J
    mult = rng.integers(0, 4, size=nb)
    mult[[2, 5, 9, 11]] = [0, 1, J, J + 1]
    keys = np.repeat(np.arange(1, nb + 1), mult)
    T = len(keys) + 5
    keys = np.concatenate([keys, np.full(5, msm3._BIG)]).astype(np.int32)
    limbs = rng.integers(0, 1 << 16, size=(48, T))
    limbs[15::16] = rng.integers(0, int(fq.P2[15]), size=(3, T))
    pts = msm3.pack_array(torch.from_numpy(limbs.astype(np.int32)))

    dense, maxmult = msm3._dense_buckets(torch.from_numpy(keys), pts, J, nb)
    assert dense.shape == (48, nb) and int(maxmult) == J + 1

    ident = msm3.pack_array(msm3._identity_stacked(1, "cpu"))[:, 0]
    zero = torch.zeros(1, dtype=torch.int32)
    for b in range(1, nb + 1):
        cols = [k for k in range(T) if keys[k] == b][:J]
        acc = pts[:, cols[0]] if cols else ident
        for k in cols[1:]:
            acc = msm3.jadd_packed_plain(acc[:, None], pts[:, k : k + 1], zero)[:, 0]
        assert torch.equal(dense[:, b - 1], msm3.unpack_array(acc[:, None])[:, 0]), b


def test_suffix_fold_rejects_bad_widths():
    for shape in ((48, 12), (48, 1), (24, 16), (48, 4, 4)):
        with pytest.raises(ValueError, match="suffix_fold"):
            msm3.suffix_fold(torch.zeros(shape, dtype=torch.int32))
