"""Plookup: the standalone single-table lookup argument, on torch tensors.

Counterpart of the JAX package's `lookup.py` (Gabizon-Williamson,
"plookup: A simplified polynomial protocol for lookup tables"), on the
port's NTT (`ops/ntt.py`), limb algebra (`ops/limbs.py`), commit engine
(`FixedBaseMSM`) and prover helpers:

* witness values f_1..f_{n-1} are proven to ALL lie in a public table
  t_1..t_n (multiset inclusion), via the sorted-concatenation polynomials
  h1/h2 and a randomized grand product Z (`_prefix_product`);
* the quotient is built on the 4n coset (`_coset_x_impl`, the NTT) and
  committed as one polynomial of 3n coefficients, so the SRS must hold at
  least 3n powers;
* Fiat-Shamir runs on the Merlin transcript under its own domain
  (b"plookup").

Identities over the order-n domain H = {w^0 .. w^{n-1}} (w^{n-1} plays the
paper's g^n):

  (a) L_0(x) * (Z(x) - 1) = 0
  (b) (x - w^{n-1}) * Z(x) * (1+beta) * (gamma + f(x))
        * (gamma(1+beta) + t(x) + beta*t(wx))
      - (x - w^{n-1}) * Z(wx)
        * (gamma(1+beta) + h1(x) + beta*h1(wx))
        * (gamma(1+beta) + h2(x) + beta*h2(wx))          = 0
  (c) L_{n-1}(x) * (h1(x) - h2(wx)) = 0
  (d) L_{n-1}(x) * (Z(x) - 1) = 0

The prover commits f, h1, h2, Z and q = (a + alpha*b + alpha^2*c +
alpha^3*d) / Z_H, then opens everything at zeta (and the shifted polys at
zeta*w) with two batched KZG opening proofs.  q's evaluation (Horner) and
its opening witness (synthetic division) over 3n coefficients run on the
host, as in the JAX package, each in a profiler range
("plookup_host_horner", "plookup_host_division").  `prove_lookup` runs on
the setup's device.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch

from .fields import Fr, FR_MOD
from .kzg import Setup
from .merlin import MerlinTranscript
from .ops.limbs import fr, NLIMBS, DTYPE, to_device
from .ops import ntt as _ntt
from .poly import Polynomial, Basis
from .utils.profiling import annotate
from .prover import (
    _barycentric_batch, _coset_lift, _coset_x_impl, _coset_x_consts_impl, _prefix_product,
    _shift1,
)


# ---------------------------------------------------------------------------
# Transcript (own schedule; points/scalars encoded exactly as transcript.py).
# ---------------------------------------------------------------------------

class LookupTranscript:
    def __init__(self):
        self.t = MerlinTranscript(b"plookup")

    def _point(self, label: bytes, pt):
        self.t.append_message(label, pt[0].n.to_bytes(32, "big"))
        self.t.append_message(label, pt[1].n.to_bytes(32, "big"))

    def bind_statement(self, n: int, t_1):
        """Absorb the statement (domain size + table commitment) BEFORE any
        challenge: without this the challenges are independent of the table,
        enabling adaptive-statement attacks when the table is not fixed
        out-of-band."""
        self.t.append_message(b"n", int(n).to_bytes(8, "big"))
        self._point(b"t_1", t_1)

    def _challenge(self, label: bytes) -> Fr:
        while True:
            buf = self.t.challenge_bytes(label, 255)
            x = int.from_bytes(buf, "big") % FR_MOD
            if x != 0:
                self.t.append_message(label, x.to_bytes(32, "big"))
                return Fr(x)

    def round_1(self, f_1):
        self._point(b"f_1", f_1)
        return self._challenge(b"beta"), self._challenge(b"gamma")

    def round_2(self, h1_1, h2_1, z_1):
        self._point(b"h1_1", h1_1)
        self._point(b"h2_1", h2_1)
        self._point(b"z_1", z_1)
        return self._challenge(b"alpha")

    def round_3(self, q_1):
        self._point(b"q_1", q_1)
        return self._challenge(b"zeta")

    def round_4(self, evals):
        for label, e in evals:
            self.t.append_message(label, int(e).to_bytes(32, "big"))
        return self._challenge(b"v")


# ---------------------------------------------------------------------------
# Proof container.
# ---------------------------------------------------------------------------

@dataclass
class LookupProof:
    f_1: tuple
    h1_1: tuple
    h2_1: tuple
    z_1: tuple
    q_1: tuple
    # evaluations at zeta: f, t, h1, h2, z, q; at zeta*w: t, h1, h2, z
    evals: dict
    W_z_1: tuple   # batched opening at zeta
    W_zw_1: tuple  # batched opening at zeta*w


_EVAL_ORDER = ("f", "t", "h1", "h2", "z", "q", "t_w", "h1_w", "h2_w", "z_w")


def _sorted_by_table(fvals: list[int], tvals: list[int]) -> list[int]:
    """Concatenation of f and t, sorted by t's order (paper's `s`)."""
    extra = Counter(fvals)
    s = []
    seen = set()
    for v in tvals:
        s.append(v)
        if v not in seen:
            seen.add(v)
            s.extend([v] * extra.get(v, 0))
    return s


def _mont(values: list[int], device) -> torch.Tensor:
    """Host ints -> [16, len] Montgomery limbs on `device`."""
    return to_device(fr.to_mont_host_many(values), device)


def _scalar(x, device) -> torch.Tensor:
    """A host scalar as a [16, 1] Montgomery column on `device`."""
    return fr.scalar(int(x), device)[:, None]


def _commit(setup: Setup, vals_lagrange) -> tuple:
    return setup.msm_engine.commit_mont(_ntt.ntt(vals_lagrange, inverse=True))


def _open_batch(setup: Setup, polys_lagrange, point: Fr, v: Fr):
    """One KZG opening proof for an RLC (powers of v) of Lagrange polys at
    `point`: W = (P(X) - P(point)) / (X - point), computed ELEMENTWISE on
    the domain (degree drops by one, so the quotient lives in the same
    Lagrange basis — no coset needed for openings)."""
    n = polys_lagrange[0].shape[-1]
    device = polys_lagrange[0].device
    acc = torch.zeros((NLIMBS, n), dtype=DTYPE, device=device)
    vp = Fr(1)
    for p in polys_lagrange:
        acc = fr.add(acc, fr.mul(p, _scalar(vp, device)))
        vp = vp * v
    pv = Fr(fr.from_mont_host(_ntt.barycentric_eval(acc, fr.scalar(int(point), device))))
    roots = _ntt._roots_impl(n, False, device)
    num = fr.sub(acc, _scalar(pv, device))
    den = fr.sub(roots, _scalar(point, device))
    w_vals = fr.mul(num, fr.batch_inv(den))
    return _commit(setup, w_vals), pv


def prove_lookup(setup: Setup, table: list[int], witness: list[int]) -> LookupProof:
    """Prove every witness value lies in `table` (n = len(table), pow 2)."""
    from .ec import ec_lincomb

    n = len(table)
    assert n & (n - 1) == 0 and n >= 4
    assert len(witness) == n - 1, "witness must have n-1 entries"
    tset = set(x % FR_MOD for x in table)
    fvals = [x % FR_MOD for x in witness]
    assert all(x in tset for x in fvals), "witness value outside table"
    tvals = [x % FR_MOD for x in table]
    dev = setup.device

    s = _sorted_by_table(fvals, tvals)  # length 2n - 1
    h1_v, h2_v = s[:n], s[n - 1 :]
    f_pad = fvals + [fvals[-1]]  # value at the last row is unconstrained

    F = _mont(f_pad, dev)
    T = _mont(tvals, dev)
    H1 = _mont(h1_v, dev)
    H2 = _mont(h2_v, dev)

    transcript = LookupTranscript()
    transcript.bind_statement(n, _commit(setup, T))
    f_1 = _commit(setup, F)
    beta, gamma = transcript.round_1(f_1)

    # Grand product over i in [0, n-2] (last ratio fixed to 1):
    #   num_i = (1+beta)(gamma+f_i)(gamma(1+beta)+t_i+beta t_{i+1})
    #   den_i = (gamma(1+beta)+h1_i+beta h1_{i+1})(gamma(1+beta)+h2_i+beta h2_{i+1})
    bl = _scalar(Fr(1) + beta, dev)
    gl = _scalar(gamma, dev)
    gbl = _scalar(gamma * (Fr(1) + beta), dev)
    betal = _scalar(beta, dev)
    one = fr.const("ONE_MONT", dev, 2)

    num = fr.mul(
        fr.mul(bl, fr.add(gl, F)),
        fr.add(fr.add(gbl, T), fr.mul(betal, _shift1(T))),
    )
    den = fr.mul(
        fr.add(fr.add(gbl, H1), fr.mul(betal, _shift1(H1))),
        fr.add(fr.add(gbl, H2), fr.mul(betal, _shift1(H2))),
    )
    # Neutralize the wrap-around row (i = n-1): ratio 1.
    last = torch.arange(n, device=dev) == n - 1
    num = torch.where(last, one, num)
    den = torch.where(last, one, den)
    Z, z_last = _prefix_product(num, den)
    assert fr.from_mont_host(z_last) == 1, (
        "lookup grand product does not close (witness not in table?)"
    )

    h1_1 = _commit(setup, H1)
    h2_1 = _commit(setup, H2)
    z_1 = _commit(setup, Z)
    alpha = transcript.round_2(h1_1, h2_1, z_1)

    # Quotient on the 4n coset: the nine rows, then L_0 and L_{n-1}.
    off = Fr(5)  # fixed coset offset (any non-domain element)
    offl = fr.scalar(int(off), dev)
    units = torch.zeros((NLIMBS, 2, n), dtype=DTYPE, device=dev)
    units[:, 0, 0] = fr.const("ONE_MONT", dev)
    units[:, 1, n - 1] = fr.const("ONE_MONT", dev)
    stack = torch.stack(
        [F, T, H1, H2, Z, _shift1(T), _shift1(H1), _shift1(H2), _shift1(Z)],
        dim=1,
    )  # [16, 9, n]
    bigs = _coset_lift(_ntt.ntt(torch.cat([stack, units], dim=1), inverse=True), offl, n)
    (Fb, Tb, H1b, H2b, Zb, Tsb, H1sb, H2sb, Zsb, L0b, Lnb) = (
        bigs[:, i, :] for i in range(11)
    )

    qroots, w4p = _coset_x_consts_impl(n, dev)
    xvals, zh_inv, _ = _coset_x_impl(offl, fr.scalar(int(off**n), dev), qroots, w4p)
    xm = fr.sub(xvals, _scalar(Fr.root_of_unity(n) ** (n - 1), dev))  # (x - w^{n-1})

    al = _scalar(alpha, dev)
    a_t = fr.mul(L0b, fr.sub(Zb, one))
    b_t = fr.sub(
        fr.mul(
            fr.mul(fr.mul(xm, Zb), fr.mul(bl, fr.add(gl, Fb))),
            fr.add(fr.add(gbl, Tb), fr.mul(betal, Tsb)),
        ),
        fr.mul(
            fr.mul(xm, Zsb),
            fr.mul(
                fr.add(fr.add(gbl, H1b), fr.mul(betal, H1sb)),
                fr.add(fr.add(gbl, H2b), fr.mul(betal, H2sb)),
            ),
        ),
    )
    c_t = fr.mul(Lnb, fr.sub(H1b, H2sb))
    d_t = fr.mul(Lnb, fr.sub(Zb, one))
    # a + alpha*(b + alpha*(c + alpha*d)) = a + alpha b + alpha^2 c + alpha^3 d
    ident = fr.add(
        a_t,
        fr.mul(al, fr.add(b_t, fr.mul(al, fr.add(c_t, fr.mul(al, d_t))))),
    )
    quot = fr.mul(ident, zh_inv)
    del bigs
    qcoeffs = _ntt.coset_to_coeffs(quot, fr.scalar(int(Fr(1) / off), dev))
    # Degree < 3n (the b-term is deg 3n-2): commit the first 3n coefficients
    # as one polynomial.
    tail = fr.from_mont_host_many(qcoeffs[:, 3 * n :])
    assert tail == [0] * n, "lookup quotient degree >= 3n"
    qc = qcoeffs[:, : 3 * n]
    assert 3 * n <= setup.msm_engine.n, "SRS too small for lookup quotient"
    q_1 = setup.msm_engine.commit_mont(qc)
    zeta = transcript.round_3(q_1)

    # Openings.
    root = Fr.root_of_unity(n)
    rows = torch.stack([F, T, H1, H2, Z, T, H1, H2, Z], dim=1)
    pts = torch.stack([fr.scalar(int(zeta), dev)] * 5 + [fr.scalar(int(zeta * root), dev)] * 4, dim=1)
    evs = [Fr(v) for v in fr.from_mont_host_many(_barycentric_batch(rows, pts, n))]
    qc_ints = Polynomial(qc, Basis.MONOMIAL).to_ints()
    with annotate("plookup_host_horner"):
        q_ev = Fr(0)
        for c in reversed(qc_ints):
            q_ev = q_ev * zeta + Fr(c)
    evals = dict(zip(("f", "t", "h1", "h2", "z"), evs[:5]))
    evals["q"] = q_ev
    evals.update(zip(("t_w", "h1_w", "h2_w", "z_w"), evs[5:]))
    v = transcript.round_4([(k.encode(), evals[k]) for k in _EVAL_ORDER])

    # Batched opening at zeta: RLC of the five degree-<n Lagrange polys
    # (weights v^0..v^4, witness computed elementwise on the domain) plus
    # q as ONE degree-<3n coefficient polynomial at weight v^5 (witness by
    # synthetic division on the host); the combined W commitment is the
    # point sum.
    W5_1, _ = _open_batch(setup, [F, T, H1, H2, Z], zeta, v)
    wq = [0] * (3 * n)
    with annotate("plookup_host_division"):
        b = Fr(0)
        for i in range(3 * n - 1, 0, -1):  # (q(X) - q(zeta)) / (X - zeta)
            b = Fr(qc_ints[i]) + zeta * b
            wq[i - 1] = b.n
    Wq_1 = setup.msm_engine.commit_mont(_mont(wq, dev))
    W_z_1 = ec_lincomb([(W5_1, 1), (Wq_1, v**5)])
    W_zw_1, _ = _open_batch(setup, [T, H1, H2, Z], zeta * root, v)

    return LookupProof(
        f_1, h1_1, h2_1, z_1, q_1, {k: v_.n for k, v_ in evals.items()},
        W_z_1, W_zw_1,
    )


def verify_lookup(
    setup: Setup, table: list[int], proof: LookupProof, t_1=None
) -> bool:
    """Verify a LookupProof against `table` (t_1: optional precomputed
    table commitment — the verifier's preprocessed input)."""
    from .ec import G1, G2, ec_lincomb, ec_mul, pt_add
    from .pairing import pairings_equal

    n = len(table)
    tvals = [x % FR_MOD for x in table]
    if t_1 is None:
        t_1 = _commit(setup, _mont(tvals, setup.device))

    transcript = LookupTranscript()
    transcript.bind_statement(n, t_1)
    beta, gamma = transcript.round_1(proof.f_1)
    alpha = transcript.round_2(proof.h1_1, proof.h2_1, proof.z_1)
    zeta = transcript.round_3(proof.q_1)
    e = {k: Fr(v) for k, v in proof.evals.items()}
    v = transcript.round_4([(k.encode(), e[k]) for k in _EVAL_ORDER])

    root = Fr.root_of_unity(n)
    zh_ev = zeta**n - 1
    l0_ev = zh_ev / (n * (zeta - 1))
    ln_ev = (zh_ev * root ** (n - 1)) / (n * (zeta - root ** (n - 1)))

    one_b = Fr(1) + beta
    gb = gamma * one_b
    xm = zeta - root ** (n - 1)
    a_t = l0_ev * (e["z"] - 1)
    b_t = (
        xm * e["z"] * one_b * (gamma + e["f"]) * (gb + e["t"] + beta * e["t_w"])
        - xm * e["z_w"] * (gb + e["h1"] + beta * e["h1_w"])
        * (gb + e["h2"] + beta * e["h2_w"])
    )
    c_t = ln_ev * (e["h1"] - e["h2_w"])
    d_t = ln_ev * (e["z"] - 1)
    ident = a_t + alpha * (b_t + alpha * (c_t + alpha * d_t))
    if ident != e["q"] * zh_ev:
        return False

    # KZG batch checks: the prover's W_z opens the RLC (powers of v) of
    # (f, t, h1, h2, z, q) at zeta — q as one degree-<3n polynomial at
    # weight v^5 — and W_zw opens (t, h1, h2, z) at zeta*w.
    vp = [Fr(1)]
    for _ in range(8):
        vp.append(vp[-1] * v)
    agg_z = ec_lincomb(
        [
            (proof.f_1, vp[0]), (t_1, vp[1]), (proof.h1_1, vp[2]),
            (proof.h2_1, vp[3]), (proof.z_1, vp[4]),
            (proof.q_1, vp[5]),
        ]
    )
    val_z = (
        vp[0] * e["f"] + vp[1] * e["t"] + vp[2] * e["h1"]
        + vp[3] * e["h2"] + vp[4] * e["z"] + vp[5] * e["q"]
    )
    agg_zw = ec_lincomb(
        [
            (t_1, vp[0]), (proof.h1_1, vp[1]), (proof.h2_1, vp[2]),
            (proof.z_1, vp[3]),
        ]
    )
    val_zw = (
        vp[0] * e["t_w"] + vp[1] * e["h1_w"] + vp[2] * e["h2_w"]
        + vp[3] * e["z_w"]
    )

    for agg, val, W, point in (
        (agg_z, val_z, proof.W_z_1, zeta),
        (agg_zw, val_zw, proof.W_zw_1, zeta * root),
    ):
        if not pairings_equal(pt_add(setup.X2, ec_mul(G2, -point)), W,
                              G2, ec_lincomb([(agg, 1), (G1, -val)])):
            return False
    return True
