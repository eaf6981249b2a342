"""K8a's window sum and K6's paired mixed add, modelled step for step (CPU).

Neither kernel runs here (no card), so their schedules do, in Python:

  * k8a_window_kernel (csrc/mont.cu) walks each point's tree of W - 1 adds
    depth-first, a left sibling waiting at its level until its right one is
    done.  Its model below, on the plain `_kern_add`, equals the plain
    level-order halving `jac_window_sum_plain` in raw limbs, and
    `Setup.generate`, which gathers window-major and sums through
    `jac_window_sum`, still gives tau^i * G.  The host oracle is the JAX
    package's `plonkathon_tpu.ec` (plain Python, compiles nothing),
    compared by integer coordinates.
  * jac_madd_core_pair and jac_madd_selects (csrc/g1.cuh) split
    `_kern_madd` between two threads that swap results by shuffles.  The
    model runs both threads as generators, each `yield` one
    `fe_from_pair`, with the operand selects as the CUDA source issues them;
    it equals the plain `_kern_madd` and the TPU body `pallas_mont._kern_madd`
    (called as a plain jnp function) in raw limbs, alone and inside a model
    of k6_kernel's scan with its ragged tail of thread pairs.
"""

import numpy as np
import pytest
import torch

from plonkathon_tpu.ec import G1, pt_mul
from plonkathon_tpu.fields import FR_MOD
from plonkathon_tpu.ops import pallas_mont as PM
from plonkathon_tpu_torch import Setup
from plonkathon_tpu_torch.ops import cuda_mont as CM, msm2 as TM
from plonkathon_tpu_torch.ops.curve import jac_to_affine_host
from plonkathon_tpu_torch.ops.limbs import fq_plain

from test_torch_kernels import assert_raw_equal, jl
from test_torch_kernels_cuda import (
    coords, rand_limbs, real_point, scan_inputs, window_points,
)


# ---------------------------------------------------------------------------
# K8a: the window sum.
# ---------------------------------------------------------------------------

def depth_first(leaves, add):
    """k8a_window_kernel's loop: leaves[j] is the pair of windows (2j, 2j + 1);
    returns the sum and the most sums that waited at once."""
    windows = 2 * len(leaves)
    pend, most = {}, 0
    acc, leaf, lvl, carry = None, 0, 0, False
    for k in range(windows - 1):
        if carry:
            p, q = pend.pop(lvl), acc
            lvl += 1
        else:
            p, q = leaves[leaf]
            lvl = 0
        acc = add(p, q)
        carry = (leaf >> lvl) & 1
        if not carry:
            if k + 1 < windows - 1:
                pend[lvl] = acc
                most = max(most, len(pend))
            leaf += 1
    return acc, most


def ints(pt):
    """A point of either package as integer coordinates (None stays None)."""
    return None if pt is None else tuple(int(c) for c in pt)


def level_order(xs, add):
    while len(xs) > 1:
        xs = [add(xs[2 * j], xs[2 * j + 1]) for j in range(len(xs) // 2)]
    return xs[0]


def test_window_sum_tree_for_every_width():
    """Symbolically, for W = 2 .. 32: the depth-first walk builds the level
    order's tree, add for add and operands in order, with at most
    log2(W) - 1 sums waiting (4 slots at W = 32)."""
    for log_w in range(1, 6):
        w = 1 << log_w
        xs = list(range(w))
        got, most = depth_first([(xs[2 * j], xs[2 * j + 1]) for j in range(w // 2)],
                                lambda a, b: (a, b))
        assert got == level_order(xs, lambda a, b: (a, b))
        assert most == log_w - 1


def test_window_sum_depth_first_equals_level_order():
    """The kernel's walk on the plain add equals the plain level-order
    halving (`jac_window_sum_plain`) in raw limbs; points 0-2 decode to
    the host oracle's sums: 32 P, the identity (P - P, 16 times) and
    2 (P + Q)."""
    x, y, z = window_points(np.random.default_rng(50), 4)
    leaves = [
        tuple((x[:, k], y[:, k], z[:, k]) for k in (2 * j, 2 * j + 1)) for j in range(16)
    ]
    got, _ = depth_first(leaves, lambda a, b: CM._kern_add(fq_plain, a, b))
    want = CM.jac_window_sum_plain((x, y, z))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    P, Q = 0xC0FFEE, 0xBEEF
    sums = [jac_to_affine_host(tuple(c[:, i] for c in got)) for i in range(3)]
    assert [ints(s) for s in sums] == [
        ints(pt_mul(G1, 32 * P)), None, ints(pt_mul(G1, 2 * (P + Q)))
    ]


def test_setup_generate_window_major_matches_host_powers():
    tau = 0x1234567
    setup = Setup.generate(2**4, tau=tau, device="cpu")
    assert [ints(p) for p in setup.powers_of_x] == [
        ints(pt_mul(G1, pow(tau, i, FR_MOD))) for i in range(2**4)
    ]


# ---------------------------------------------------------------------------
# K6: the mixed add on a thread pair.
# ---------------------------------------------------------------------------

def madd_pair_thread(odd, p, x2, y2):
    """One thread of jac_madd_core_pair; `o = yield v` is fe_from_pair(v).
    Its squares of rounds 2 and 3 are products of an element with itself,
    as in the CUDA source.  Returns (X3, Y3, Z3), H, R."""
    k = fq_plain
    sel = lambda a, b: a if odd else b
    X1, Y1, Z1 = p
    Z1Z1 = k.sqr(Z1)
    t = k.mul(sel(Z1, x2), Z1Z1)  # U2 | Z1^3
    h = k.sub(t, X1)
    u = k.mul(sel(y2, h), sel(t, h))  # HH | S2
    o = yield sel(u, t)
    U2, S2 = sel(o, t), sel(u, o)
    H, R = k.sub(U2, X1), k.sub(S2, Y1)
    t1 = k.mul(sel(R, H), sel(R, u))  # HHH | R^2
    t2 = k.mul(sel(Z1, X1), sel(H, u))  # V | Z3
    o1 = yield t1
    o2 = yield t2
    HHH, RR, V, Z3 = sel(o1, t1), sel(t1, o1), sel(o2, t2), sel(t2, o2)
    X3 = k.sub(k.sub(RR, HHH), k.add(V, V))
    t4 = k.mul(sel(Y1, R), sel(HHH, k.sub(V, X3)))  # R (V - X3) | Y1 HHH
    o4 = yield t4
    Y3 = k.sub(sel(o4, t4), sel(t4, o4))
    return (X3, Y3, Z3), H, R


def run_pair(even, odd):
    """Step both threads in lockstep, each receiving what the other sent."""
    sent = [next(even), next(odd)]
    while True:
        out = []
        for g, recv in ((even, sent[1]), (odd, sent[0])):
            try:
                out.append(g.send(recv))
            except StopIteration as stop:
                out.append(stop)
        if all(isinstance(v, StopIteration) for v in out):
            return [v.value for v in out]
        sent = out


def madd_selects(r, p, x2, y2, H, R):
    """jac_madd_selects: doubling where p == q, Z = 0 where p == -q, q
    where p is the identity."""
    k = fq_plain
    p_inf = k.is_zero(p[2])
    h_zero = k.is_zero(H) & ~p_inf
    same = h_zero & k.is_zero(R)
    cancel = h_zero & ~k.is_zero(R)
    X3, Y3, Z3 = (k.select(same, d, c) for d, c in zip(CM._kern_double(k, p), r))
    Z3 = k.select(cancel, torch.zeros_like(Z3), Z3)
    one = k.full("ONE_MONT", Z3)
    return k.select(p_inf, x2, X3), k.select(p_inf, y2, Y3), k.select(p_inf, one, Z3)


def madd_pair(p, x2, y2):
    """Both threads' results after the selects (each thread its own)."""
    res = run_pair(madd_pair_thread(0, p, x2, y2), madd_pair_thread(1, p, x2, y2))
    return [madd_selects(r, p, x2, y2, H, R) for r, H, R in res]


def madd_lanes(rng, kind, w=64):
    """(p Jacobian, x2, y2): random lazy coordinates, or real points:
    identity + Q, P + P with Z = 1, 2P (Z != 1) + 2P, P + (-P),
    2P + (-2P), P + Q, and random lanes after them."""
    p = coords(torch.cat([rand_limbs(rng, fq_plain, w, edges=False) for _ in range(3)]))
    q = coords(torch.cat([rand_limbs(rng, fq_plain, w, edges=False) for _ in range(2)]))
    p, q = [c.clone() for c in p], [c.clone() for c in q]
    if kind == "edges":
        P, negP = real_point(0xC0FFEE)
        Q, _ = real_point(0xBEEF)
        P2 = torch.cat(CM._kern_double(fq_plain, coords(P)))  # 2P, Z = 2Y
        P2_aff = real_point(2 * 0xC0FFEE)
        ident = torch.cat([P[:32], torch.zeros_like(P[32:])])
        lanes = ((ident, Q), (P, P), (P2, P2_aff[0]), (P, negP), (P2, P2_aff[1]), (P, Q))
        for lane, (a, b) in enumerate(lanes):
            for i in range(3):
                p[i][:, lane] = a[16 * i : 16 * (i + 1), 0]
            for i in range(2):
                q[i][:, lane] = b[16 * i : 16 * (i + 1), 0]
    return tuple(p), q[0], q[1]


@pytest.mark.parametrize("kind", ["edges", "random"])
def test_madd_pair_schedule_equals_kern_madd(kind):
    p, x2, y2 = madd_lanes(np.random.default_rng(51 if kind == "edges" else 52), kind)
    even, odd = madd_pair(p, x2, y2)
    want = CM._kern_madd(fq_plain, p, (x2, y2))
    body = PM._kern_madd(PM.KQ, tuple(jl(c) for c in p), (jl(x2), jl(y2)))
    for e, o, w, b in zip(even, odd, want, body):
        assert torch.equal(e, w) and torch.equal(o, w)
        assert_raw_equal(e, b)
    if kind == "edges":
        z = want[2]
        assert fq_plain.is_zero(z[:, 3:5]).all()  # P + (-P), 2P + (-2P)
        assert not fq_plain.is_zero(z[:, :3]).any()


def test_k6_pair_scan_with_ragged_tail_equals_run_scan_plain():
    """k6_kernel's threads: t -> chunk t >> 1, a tail pair past the last
    chunk mirrors it and stores nothing; fresh steps restart at the
    identity; the even thread stores X and Y, the odd one Z.  37 chunks in
    blocks of 64 threads leave 27 tail pairs; chunk 0 doubles, chunk 1
    cancels."""
    d_t, p_t, pts = scan_inputs(np.random.default_rng(53), 6, 37)
    steps, chunks = d_t.shape
    threads = 64
    pairs = -(-2 * chunks // threads) * threads // 2
    on = torch.arange(pairs) < chunks
    ch = torch.where(on, torch.arange(pairs), torch.full((pairs,), chunks - 1))
    ident = TM.unstack_points(TM._identity_stacked(pairs, "cpu"), (pairs,))
    acc = [ident, ident]  # each thread's own accumulator
    out = torch.full((steps, 48, chunks), -1, dtype=torch.int32)
    for s in range(steps):
        fresh = d_t[s, ch] != p_t[s, ch]
        x2, y2 = pts[s, :16, ch], pts[s, 16:, ch]
        acc = [tuple(fq_plain.select(fresh, i, a) for i, a in zip(ident, th)) for th in acc]
        res = run_pair(*(madd_pair_thread(odd, acc[odd], x2, y2) for odd in (0, 1)))
        acc = [madd_selects(r, acc[odd], x2, y2, H, R) for odd, (r, H, R) in enumerate(res)]
        out[s, :16, ch[on]] = acc[0][0][:, on]
        out[s, 16:32, ch[on]] = acc[0][1][:, on]
        out[s, 32:, ch[on]] = acc[1][2][:, on]
    assert torch.equal(out, TM.run_scan_plain(d_t, p_t, pts))
