"""The plain versions of the msm3 kernels K3 and K4 and of K9, and msm3's
host-free helpers, against the JAX package (CPU).

  K3 madd_packed  <-> msm3._madd_packed_kernel, the whole body (unpack,
                      negate, incomplete add, selects, pack)
  K4 jadd_packed  <-> msm3._jadd_packed_kernel
  K9 butterfly    <-> pallas_mont._butterfly_kernel

The TPU bodies run as plain functions: they index their input refs by row,
which a jnp array allows, and assign their output ref's rows, which a
Python list allows.  Results are compared in raw words, exactly, under
every value of the mask bits.  `pack_array`, `unpack_array` and
`signed_digits16` are compared with the JAX functions called eagerly.
"""

import numpy as np
import torch

import jax.numpy as jnp

from plonkathon_tpu.ops import msm3 as J3, pallas_mont as PM
from plonkathon_tpu_torch.fields import FR_MOD
from plonkathon_tpu_torch.ops import cuda_mont as CM, msm3 as T3
from plonkathon_tpu_torch.ops.limbs import fq, fr, encode_ints, to_device

from test_torch_kernels import assert_raw_equal
from test_torch_kernels_cuda import packed_inputs, rand_limbs

torch.set_num_threads(1)  # small tensors: threads only contend with xdist


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _body(kernel, acc, q, mask):
    """Run a packed Pallas kernel body on jnp arrays; returns its 24 rows."""
    out = [None] * J3.PACKED_JAC
    kernel(_u32(acc), _u32(q), _u32(mask)[None].astype(jnp.int32), out)
    return out


def test_k3_madd_packed_plain_matches_kernel_body():
    acc, q, mask = packed_inputs(np.random.default_rng(20), "madd")
    got = T3.madd_packed_plain(acc, q, mask)
    assert_raw_equal(got, _body(J3._madd_packed_kernel, acc, q, mask))
    assert torch.equal(T3.madd_packed(acc, q, mask), got)  # CPU wrapper = plain
    # Lanes 1 and 3 are fresh: Q and -Q themselves, with Z = 1.
    limbs = T3.unpack_array(got)
    qx, qy = T3.unpack_array(q)[:16, 1], T3.unpack_array(q)[16:, 1]
    assert torch.equal(limbs[:16, 1], qx) and torch.equal(limbs[16:32, 1], qy)
    assert torch.equal(limbs[:16, 3], qx)
    assert torch.equal(limbs[16:32, 3], fq.sub(torch.zeros_like(qy), qy))
    assert fq.from_mont_host(limbs[32:, 1]) == fq.from_mont_host(limbs[32:, 3]) == 1


def test_k4_jadd_packed_plain_matches_kernel_body():
    acc, q, mask = packed_inputs(np.random.default_rng(21), "jadd")
    assert mask[:4].tolist() == [0, 1, 4, 5]
    got = T3.jadd_packed_plain(acc, q, mask)
    assert_raw_equal(got, _body(J3._jadd_packed_kernel, acc, q, mask))
    assert torch.equal(T3.jadd_packed(acc, q, mask), got)
    assert torch.equal(got[:, 1], q[:, 1])  # fresh restarts at q
    assert torch.equal(got[:, 2], acc[:, 2])  # dead keeps the accumulator
    assert torch.equal(got[:, 3], acc[:, 3])  # dead wins over fresh


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(22)
    limbs = torch.from_numpy(rng.integers(0, 1 << 16, size=(48, 9)).astype(np.int32))
    limbs[1::2, 0] = 0xFFFF  # words >= 2^31: negative as int32
    limbs[1::2, 1] = 0x8000
    packed = T3.pack_array(limbs)
    assert packed.dtype == torch.int32 and bool((packed[:, 0] < 0).all())
    assert np.array_equal(packed.numpy().astype(np.uint32), np.asarray(J3.pack_array(_u32(limbs))))
    assert torch.equal(T3.unpack_array(packed), limbs)
    assert np.array_equal(
        T3.unpack_array(packed).numpy().astype(np.uint32),
        np.asarray(J3.unpack_array(_u32(packed))),
    )


def test_signed_digits16_matches_jax():
    """Carries between windows: 0x7FFF and 0x8000 stay positive, 0x8001 and
    0xFFFF recode to a negative digit and carry into the next window."""
    rng = np.random.default_rng(23)
    edge = [0x7FFF, 0x8000, 0x8001, 0xFFFF, 0]
    ints = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(40)]
    ints += [sum(e << (16 * w) for w in range(15)) for e in edge]  # top limb 0
    ints += [0xFFFF | (0xFFFF << 16) | (0x7FFF << 32), 0x8001 | (0x7FFF << 16), FR_MOD - 1]
    raw = to_device(encode_ints(ints), "cpu")
    key, payload = T3.signed_digits16(raw, 64)
    jkey, jpayload = J3.signed_digits16(_u32(raw), 64)
    assert np.array_equal(key.numpy(), np.asarray(jkey))
    assert np.array_equal(payload.numpy(), np.asarray(jpayload))
    # The digits recompose to the scalar.
    m = len(ints)
    signed = torch.where((payload & 1) != 0, -key, key).reshape(16, m).tolist()
    for i, n in enumerate(ints):
        assert sum(signed[w][i] << (16 * w) for w in range(16)) == n
    assert int(key.max()) <= 1 << 15


def test_plan_params_shapes():
    """T covers every run end, T/16 chunks feed the merge scan, and the
    commit sizes of the n = 2^18 and CPU-test paths get the stated plans."""
    for m in (1, 3, 64, 512, 8192, 1 << 16, 1 << 18):
        S, C, kpad, T, T2 = T3.plan_params(16 * m)
        assert S * C == kpad >= 16 * m and C & (C - 1) == 0
        assert T % 16 == 0 and T2 <= T <= kpad
        assert T >= min(kpad, T3.NBUCKET + C) and T2 >= min(T, T3.NBUCKET + T // 16)
    assert T3.plan_params(16 << 18) == (32, 1 << 17, 1 << 22, 1 << 18, 1 << 16)
    assert T3.plan_params(16 * 512) == (32, 256, 8192, 8192, 8192)


def test_k9_butterfly_plain_matches_kernel_body():
    rng = np.random.default_rng(24)
    e, o, t = (rand_limbs(rng, fr) for _ in range(3))
    lo_ref, hi_ref = [None] * 16, [None] * 16
    PM._butterfly_kernel(_u32(e), _u32(o), _u32(t), lo_ref, hi_ref)
    lo, hi = CM.butterfly_plain(e, o, t)
    assert_raw_equal(lo, lo_ref)
    assert_raw_equal(hi, hi_ref)
    lo2, hi2 = CM.butterfly(e, o, t)  # CPU wrapper = plain
    assert torch.equal(lo, lo2) and torch.equal(hi, hi2)
