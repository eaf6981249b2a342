"""The point kernels K5, K6, K7 and K8b against their plain versions, on a
card only (the builders and the `cuda` fixture are
tests/test_torch_kernels_cuda.py's; this file imports no JAX either).

Each test launches the kernel on CUDA tensors and compares the result with
its plain torch version in raw limbs, exactly.  On the card run it with
tests/test_torch_kernels_cuda.py (that file's docstring has the command).

Why a file of its own: xdist's `--dist loadfile` queues test files by
their count of tests, largest first, ties by name, and hands a worker its
next file when two of its tests remain.  The worker running the JAX
package's tests/test_sharded.py, the Tier-1 run's longest file, takes the
queue's head at its fourth test and runs it after its last, past the run's
clock on a slow machine.  These 6 tests sort third among the port's files
of 6 (tests/test_torch_build.py asserts it), which puts them at the head
then; without a card they skip, so the clock cuts no pass with them.
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu_torch.ops import cuda_lib, cuda_mont as CM, msm2 as TM
from plonkathon_tpu_torch.ops.limbs import encode_ints, fq

from test_torch_kernels_cuda import coords, cuda, point_pairs, scan_inputs, top_limbs  # noqa: F401


@pytest.mark.cuda
def test_cuda_k5_equals_plain(cuda):
    a, b = (x.to(cuda) for x in point_pairs(np.random.default_rng(12), 1000))
    assert torch.equal(TM.jadd_stacked(a, b), TM.jadd_stacked_plain(a, b))


@pytest.mark.cuda
def test_cuda_k6_equals_plain(cuda):
    d_t, p_t, pts = (x.to(cuda) for x in scan_inputs(np.random.default_rng(13), 8, 300))
    assert torch.equal(TM.run_scan(d_t, p_t, pts), TM.run_scan_plain(d_t, p_t, pts))


@pytest.mark.cuda
def test_cuda_k6_ragged_warp_equals_plain(cuda):
    """2^10 + 8 chunks: the last warp's 16 thread pairs hold 8 chunks and 8
    mirrors of the last one, which must store nothing; chunk 0 doubles,
    chunk 1 cancels."""
    chunks = (1 << 10) + 8
    d_t, p_t, pts = (x.to(cuda) for x in scan_inputs(np.random.default_rng(43), 12, chunks))
    cuda_lib.reset_launches()
    got = TM.run_scan(d_t, p_t, pts)
    assert cuda_lib.LAUNCHES["K6"] == 1
    assert torch.equal(got, TM.run_scan_plain(d_t, p_t, pts))


@pytest.mark.cuda
@pytest.mark.parametrize("n_times", [8, 16])
def test_cuda_k7_equals_plain(cuda, n_times):
    """Lane 0 and lanes 8-11 are identities (Z = 0, random X and Y), lanes
    5-7 have every coordinate at 2p - 1, lane 12 has Z = p."""
    a, _ = point_pairs(np.random.default_rng(14), 700)
    a[:, 5:8] = top_limbs(3, 48)
    a[32:, 8:12] = 0
    a[32:, 12] = torch.from_numpy(encode_ints([fq.modulus]))[:, 0]
    p = tuple(c.to(cuda) for c in coords(a))
    got = CM.jac_double_n(p, n_times)
    want = CM.jac_double_n_plain(p, n_times)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not got[2][:, [0, 8, 9, 10, 11]].any()  # identities stay identities


@pytest.mark.cuda
def test_cuda_k8b_equals_plain(cuda):
    a, b = (coords(x.to(cuda)) for x in point_pairs(np.random.default_rng(18), 1000))
    got, want = CM.jac_madd(a, b[:2]), CM.jac_madd_plain(a, b[:2])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
