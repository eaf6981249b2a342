"""The 5-round PLONK prover on torch tensors.

Rounds and algebra match the JAX package's prover exactly, so proofs are
bit-identical (Merlin Fiat-Shamir is deterministic):

  1. wire polynomials A, B, C + commitments
  2. permutation grand product Z (log-depth prefix product) + commitment
  3. quotient on the 4n coset, split T1/T2/T3 + commitments
  4. openings at zeta / zeta*omega
  5. linearization R, opening proofs W_z, W_zw + commitments

Every field multiply goes through `FieldOps.mul` (the Montgomery-product
kernel on CUDA), every NTT stage through the butterfly kernel, and every
commitment through the fixed-base MSM engine (msm2, or msm3 from m = 8192); only the transcript crosses to the
host between rounds, and each round fetches its commitments once.

Extensions, as in the JAX package: the TurboPlonK cube gate (a QCUBE
selector; the quotient gains q_cube * A^3 and R gains QCUBE * a_eval^3),
PlonKup lookups (plonkup.py: round 1 also commits f, h1, h2, round 2 the
lookup grand product Z2, round 3 folds five identities in at alpha^3 ...
alpha^7, round 4 opens eight more values, round 5 linearizes them) and ZK
blinding (`Program(blinding_rows=t)`): the wires' last t rows take fresh
random values, and Z (with lookups also f, h1, h2 and Z2) gains a
Z_H-multiple r(X) * (X^n - 1) with fresh coefficients, so those commits
are n + 2 or n + 3 coefficients wide and need an SRS of n + 3 powers.
Blinders come from `secrets.randbelow`, in the JAX package's order.  With
`ProverConfig(mesh=...)` (parallel/mesh.py) every NTT, the grand product,
the quotient, the openings and the commits of a proof run length-sharded
across the mesh's ranks (parallel/sharded.py), each rank running `prove`
on its own device; as in the JAX package, a ZK-blinded circuit and a group
order that `_factor` cannot split take the single-device rounds.  B proofs
of one circuit at once are parallel/batch.py's.

The round algebra (`_perm_grand_product`, `_prefix_product`,
`_quotient_impl`, `_linearization_impl`, `_coset_lift`, `_coset_x_impl`)
takes per-proof rows [16, *batch, w], scalars [16, *batch] and static rows
broadcastable to the rows.  The prover's rounds carry a batch axis B:
`prove` runs them with B = 1, and parallel/batch.py's BatchProver with B
witnesses at once, each with its own transcript.

`debug=True` enables the internal invariant checks (gate constraint, Z
closure, quotient degree, T split, R(zeta) = 0, W degrees; with lookups
also the query column f and the Z2 closure).
"""

from __future__ import annotations

import operator
import secrets
from dataclasses import dataclass

import numpy as np
import torch

from .fields import Fr, FR_MOD
from .frontend import Program, CommonPreprocessedInput
from .kzg import Setup
from .ops.limbs import fr, NLIMBS, DTYPE, LIMB_MASK, encode_ints, to_device, resolve_device
from .ops import ntt as _ntt
from .poly import Polynomial, Basis
from .transcript import (
    Transcript,
    Message1,
    Message2,
    Message3,
    Message4,
    Message5,
)


@dataclass
class Proof:
    msg_1: Message1
    msg_2: Message2
    msg_3: Message3
    msg_4: Message4
    msg_5: Message5

    def flatten(self) -> dict:
        proof = {}
        proof["a_1"] = self.msg_1.a_1
        proof["b_1"] = self.msg_1.b_1
        proof["c_1"] = self.msg_1.c_1
        proof["z_1"] = self.msg_2.z_1
        proof["t_lo_1"] = self.msg_3.t_lo_1
        proof["t_mid_1"] = self.msg_3.t_mid_1
        proof["t_hi_1"] = self.msg_3.t_hi_1
        proof["a_eval"] = self.msg_4.a_eval
        proof["b_eval"] = self.msg_4.b_eval
        proof["c_eval"] = self.msg_4.c_eval
        proof["s1_eval"] = self.msg_4.s1_eval
        proof["s2_eval"] = self.msg_4.s2_eval
        proof["z_shifted_eval"] = self.msg_4.z_shifted_eval
        proof["W_z_1"] = self.msg_5.W_z_1
        proof["W_zw_1"] = self.msg_5.W_zw_1
        if self.msg_1.f_1 is not None:
            # PlonKup extension fields (plonkup.py).
            proof["f_1"] = self.msg_1.f_1
            proof["h1_1"] = self.msg_1.h1_1
            proof["h2_1"] = self.msg_1.h2_1
            proof["z2_1"] = self.msg_2.z2_1
            for k, val in self.msg_4.lookup_evals.items():
                proof[f"lk_{k}_eval"] = val
        return proof


# ---------------------------------------------------------------------------
# Round algebra.
# ---------------------------------------------------------------------------

def _blinders(count: int) -> list[int]:
    """`count` fresh blinding scalars from a cryptographic generator.  A
    predictable blinder leaks the witness, so never torch's or numpy's
    generators; every draw of the prover goes through here."""
    return [secrets.randbelow(FR_MOD) for _ in range(count)]


def _rlc(x, y, beta, gamma):
    return fr.add(fr.add(x, fr.mul(beta, y)), gamma)


def _prefix_product(f, g):
    """Z[0]=1; Z[i] = prod_{j<i} f[j]/g[j] along the last axis of
    [16, *batch, n]; also returns the closing values [16, *batch]."""
    n = f.shape[-1]
    steps = max((n - 1).bit_length(), 1)
    pos = torch.arange(n, device=f.device)
    one = fr.const("ONE_MONT", f.device, f.ndim)
    cf, cg = f, g
    for j in range(steps):
        shift = 1 << j
        valid = pos >= shift
        inf = torch.where(valid, torch.roll(cf, shift, dims=-1), one)
        ing = torch.where(valid, torch.roll(cg, shift, dims=-1), one)
        cf, cg = fr.mul(inf, cf), fr.mul(ing, cg)
    z_all = fr.mul(cf, fr.batch_inv(cg))
    z_last = z_all[..., -1]
    z = torch.cat([one.expand(f.shape[:-1] + (1,)), z_all[..., :-1]], dim=-1)
    return z, z_last


def _perm_grand_product(a, b, c, s1, s2, s3, roots, beta, gamma):
    """Round 2's permutation grand product Z (Lagrange values) and its
    closing value: rows [16, *batch, n], sigmas and roots broadcastable to
    them, beta and gamma [16, *batch]."""
    beta, gamma = beta[..., None], gamma[..., None]
    r2 = fr.add(roots, roots)
    r3 = fr.add(r2, roots)
    f = fr.mul(
        fr.mul(_rlc(a, roots, beta, gamma), _rlc(b, r2, beta, gamma)),
        _rlc(c, r3, beta, gamma),
    )
    g = fr.mul(
        fr.mul(_rlc(a, s1, beta, gamma), _rlc(b, s2, beta, gamma)),
        _rlc(c, s3, beta, gamma),
    )
    return _prefix_product(f, g)


def _zh_blinded(coeffs, blinders):
    """Monomial coefficients [16, m] of P(X) + r(X) * (X^m - 1), r(X) =
    sum_j blinders[j] X^j: r_j is subtracted at X^j and added at X^(m+j),
    so the result is m + len(blinders) wide."""
    k = len(blinders)
    dlo = to_device(fr.to_mont_host_many([(-v) % FR_MOD for v in blinders]), coeffs.device)
    dhi = to_device(fr.to_mont_host_many(blinders), coeffs.device)
    return torch.cat([fr.add(coeffs[:, :k], dlo), coeffs[:, k:], dhi], dim=1)


def _shift1(values):
    """Lagrange values of p(omega X): a cyclic left rotation by one row."""
    return torch.roll(values, -1, dims=-1)


def _lookup_z2(f, t, h1, h2, delta, epsilon):
    """PlonKup round-2 companion: the lookup grand product Z2 over rows
    0..n-2, the wrap-around row's ratio set to 1 (identity (b') of
    plonkup.py excludes it through its (x - w^{n-1}) factor):
      num_i = (1+d)(e+f_i)(e(1+d) + t_i + d*t_{i+1})
      den_i = (e(1+d) + h1_i + d*h1_{i+1})(e(1+d) + h2_i + d*h2_{i+1})
    Rows [16, *batch, n] (t broadcastable to them), delta and epsilon
    [16, *batch].  Returns (Z2 Lagrange values, closing value)."""
    n = f.shape[-1]
    one = fr.const("ONE_MONT", f.device, f.ndim)
    d = delta[..., None]
    e = epsilon[..., None]
    od = fr.add(one, d)
    ed = fr.mul(e, od)
    num = fr.mul(
        fr.mul(od, fr.add(e, f)),
        fr.add(fr.add(ed, t), fr.mul(d, _shift1(t))),
    )
    den = fr.mul(
        fr.add(fr.add(ed, h1), fr.mul(d, _shift1(h1))),
        fr.add(fr.add(ed, h2), fr.mul(d, _shift1(h2))),
    )
    last = (torch.arange(n, device=f.device) == n - 1)[None]
    num = torch.where(last, one, num)
    den = torch.where(last, one, den)
    return _prefix_product(num, den)


def _coset_x_consts_impl(n: int, device):
    """[16, 4n] tables for X and Z_H on the 4n coset: the powers of q (a
    4n-th root of unity) and w4^(i mod 4) with w4 = q^n of order 4."""
    q = pow(5, (FR_MOD - 1) // (4 * n), FR_MOD)
    qroots = _ntt.scalar_powers(fr.scalar(q, device), 4 * n)
    w4 = pow(q, n, FR_MOD)
    w4_4 = to_device(fr.to_mont_host_many([pow(w4, i, FR_MOD) for i in range(4)]), device)
    return qroots, w4_4.repeat(1, n)


def _coset_x_impl(offset, offset_n, qroots, w4p):
    """(X values, Z_H^-1 values, Z_H values) on the 4n coset, [16, *batch,
    4n] for offsets [16, *batch]."""
    lead = (1,) * (offset.ndim - 1)
    qroots, w4p = (t.reshape((NLIMBS,) + lead + t.shape[1:]) for t in (qroots, w4p))
    xvals = fr.mul(offset[..., None], qroots)
    one = fr.const("ONE_MONT", offset.device, offset.ndim + 1)
    zh = fr.sub(fr.mul(offset_n[..., None], w4p), one)
    return xvals, fr.batch_inv(zh), zh


# Round 3's 11 PlonKup rows, after the 15 vanilla rows and the optional
# QCUBE row ("s" = omega-shifted, ln = L_{n-1}).
LOOKUP_ROWS = ("f", "t", "ts", "h1", "h1s", "h2", "h2s", "z2", "z2s", "qk", "ln")


def _quotient_impl(
    a, b, c, pi, ql, qr, qm, qo, qc, z, zs, s1, s2, s3, l0, xvals, zh_inv,
    beta, gamma, alpha, qcube=None, lookup=None,
):
    """QUOT on the 4n coset (all inputs coset-extended, [16, *batch, 4n];
    the challenges [16, *batch]).

    `qcube` (optional): the cube-gate selector on the coset; the gate gains
    q_cube * A^3 (degree 4n - 4, inside the 4n domain).

    `lookup` (optional, PlonKup): a dict with the coset-extended rows of
    LOOKUP_ROWS and the scalar limbs delta, epsilon, tlast and gl
    (= w^{n-1}); adds the five plookup identities weighted by alpha^3 ...
    alpha^7."""
    beta = beta[..., None]
    gamma = gamma[..., None]
    alpha = alpha[..., None]
    gate = fr.add(
        fr.add(
            fr.add(fr.mul(a, ql), fr.mul(b, qr)),
            fr.add(fr.mul(fr.mul(a, b), qm), fr.mul(c, qo)),
        ),
        fr.add(pi, qc),
    )
    if qcube is not None:
        gate = fr.add(gate, fr.mul(qcube, fr.mul(fr.mul(a, a), a)))
    x2 = fr.add(xvals, xvals)
    x3 = fr.add(x2, xvals)
    num = fr.mul(
        fr.mul(
            fr.mul(_rlc(a, xvals, beta, gamma), _rlc(b, x2, beta, gamma)),
            _rlc(c, x3, beta, gamma),
        ),
        z,
    )
    den = fr.mul(
        fr.mul(
            fr.mul(_rlc(a, s1, beta, gamma), _rlc(b, s2, beta, gamma)),
            _rlc(c, s3, beta, gamma),
        ),
        zs,
    )
    perm = fr.mul(alpha, fr.sub(num, den))
    one = fr.const("ONE_MONT", a.device, a.ndim)
    start = fr.mul(fr.mul(fr.mul(alpha, alpha), fr.sub(z, one)), l0)
    ident = fr.add(gate, fr.add(perm, start))
    if lookup is not None:
        lk = lookup
        delta = lk["delta"][..., None]
        eps = lk["epsilon"][..., None]
        od = fr.add(one, delta)                 # 1 + delta
        ed = fr.mul(eps, od)                    # epsilon * (1 + delta)
        xm = fr.sub(xvals, lk["gl"][..., None])  # x - w^{n-1}
        z2m1 = fr.sub(lk["z2"], one)
        t_a = fr.mul(l0, z2m1)
        t_b = fr.sub(
            fr.mul(
                fr.mul(fr.mul(xm, lk["z2"]), fr.mul(od, fr.add(eps, lk["f"]))),
                fr.add(fr.add(ed, lk["t"]), fr.mul(delta, lk["ts"])),
            ),
            fr.mul(
                fr.mul(xm, lk["z2s"]),
                fr.mul(
                    fr.add(fr.add(ed, lk["h1"]), fr.mul(delta, lk["h1s"])),
                    fr.add(fr.add(ed, lk["h2"]), fr.mul(delta, lk["h2s"])),
                ),
            ),
        )
        t_c = fr.mul(lk["ln"], fr.sub(lk["h1"], lk["h2s"]))
        t_d = fr.mul(lk["ln"], z2m1)
        # f well-formedness: q_K*(a - f) + (1 - q_K)*(t_last - f).
        tl = fr.sub(lk["tlast"][..., None], lk["f"])
        t_e = fr.add(
            fr.mul(lk["qk"], fr.sub(a, lk["f"])),
            fr.mul(fr.sub(one, lk["qk"]), tl),
        )
        # alpha^3 * (a' + alpha*(b' + alpha*(c' + alpha*(d' + alpha*e'))))
        ext = fr.add(t_d, fr.mul(alpha, t_e))
        ext = fr.add(t_c, fr.mul(alpha, ext))
        ext = fr.add(t_b, fr.mul(alpha, ext))
        ext = fr.add(t_a, fr.mul(alpha, ext))
        a3 = fr.mul(fr.mul(alpha, alpha), alpha)
        ident = fr.add(ident, fr.mul(a3, ext))
    return fr.mul(ident, zh_inv)


def _barycentric_batch(values, xs, n: int):
    """values [16, B, n], xs [16, B] -> evals [16, B] (Montgomery)."""
    roots = _ntt._roots_impl(n, False, values.device)
    denom = fr.sub(xs[:, :, None], roots[:, None, :])
    terms = fr.mul(fr.mul(values, roots[:, None, :]), fr.batch_inv(denom))
    return _barycentric_finish(_ntt._treesum(terms), xs, n)


def _barycentric_finish(total, xs, n: int):
    """The barycentric sum of terms v_i w^i / (x - w^i), [16, B], times
    (x^n - 1) / n: the evaluations at xs [16, B]."""
    xn = fr.pow_int(xs, n)
    scale = fr.mul(
        fr.sub(xn, fr.const("ONE_MONT", xs.device, 2)),
        fr.scalar(pow(n, -1, FR_MOD), xs.device)[:, None],
    )
    return fr.mul(total, scale)


def _linearization_impl(
    bigs, t1, t2, t3, xvals,
    a_ev, b_ev, c_ev, s1_ev, s2_ev, zw_ev,
    pi_ev, l0_ev, zh_ev, zeta_n, zeta_2n,
    beta, gamma, alpha, zeta, zeta_w, v,
    qcube=None, cube_ev=None, lookup=None,
):
    """Elementwise round-5 core: (R, W_z, W_zw) values on the 4n coset.

    `qcube`, `cube_ev` (cube gates): R gains QCUBE * a_eval^3.
    `lookup` (PlonKup): a dict with the coset rows f, t, h1, h2, z2, qk, the
    host linearization scalars c_z2, c_h1, c_qk, c_const
    (plonkup.linearization_scalars) and the eight extra openings.  R gains
    the three linearized commitment terms and the constant; W_z batches
    (f, t, h1, h2) at v^6 ... v^9; W_zw becomes the RLC of (z, t, h1, h2,
    z2) at v^0 ... v^4."""
    S = lambda x: x[..., None]  # noqa: E731
    (a, b, c, _pi, ql, qr, qm, qo, qc, z, _zs, s1, s2, s3, _l0) = bigs

    beta_, gamma_, alpha_, zeta_ = S(beta), S(gamma), S(alpha), S(zeta)
    ab = fr.mul(S(a_ev), S(b_ev))
    gate = fr.add(
        fr.add(fr.add(fr.mul(qm, ab), fr.mul(ql, S(a_ev))), fr.mul(qr, S(b_ev))),
        fr.add(fr.mul(qo, S(c_ev)), fr.add(S(pi_ev), qc)),
    )
    if qcube is not None:
        gate = fr.add(gate, fr.mul(qcube, S(cube_ev)))
    zf = fr.mul(
        fr.mul(
            fr.mul(
                _rlc(S(a_ev), zeta_, beta_, gamma_),
                _rlc(S(b_ev), fr.add(zeta_, zeta_), beta_, gamma_),
            ),
            _rlc(S(c_ev), fr.add(fr.add(zeta_, zeta_), zeta_), beta_, gamma_),
        ),
        z,
    )
    sf = fr.mul(
        fr.mul(
            _rlc(S(a_ev), S(s1_ev), beta_, gamma_),
            _rlc(S(b_ev), S(s2_ev), beta_, gamma_),
        ),
        fr.add(fr.add(S(c_ev), gamma_), fr.mul(beta_, s3)),
    )
    sf = fr.mul(sf, S(zw_ev))
    perm = fr.mul(alpha_, fr.sub(zf, sf))
    one = fr.const("ONE_MONT", a.device, a.ndim)
    start = fr.mul(fr.mul(fr.mul(alpha_, alpha_), S(l0_ev)), fr.sub(z, one))
    t_combined = fr.add(fr.add(t1, fr.mul(t2, S(zeta_n))), fr.mul(t3, S(zeta_2n)))
    r_core = fr.add(gate, fr.add(perm, start))
    if lookup is not None:
        lk = lookup
        r_core = fr.add(r_core, fr.mul(S(lk["c_z2"]), lk["z2"]))
        r_core = fr.add(r_core, fr.mul(S(lk["c_h1"]), lk["h1"]))
        r_core = fr.add(r_core, fr.mul(S(lk["c_qk"]), lk["qk"]))
        r_core = fr.add(r_core, S(lk["c_const"]))
    r_big = fr.sub(r_core, fr.mul(S(zh_ev), t_combined))

    # W_z = (R + sum v^k (poly - eval)) / (X - zeta)
    acc = r_big
    vp = v
    opened = [(a, a_ev), (b, b_ev), (c, c_ev), (s1, s1_ev), (s2, s2_ev)]
    if lookup is not None:
        opened += [
            (lookup["f"], lookup["f_ev"]), (lookup["t"], lookup["t_ev"]),
            (lookup["h1"], lookup["h1_ev"]), (lookup["h2"], lookup["h2_ev"]),
        ]
    for poly, ev in opened:
        acc = fr.add(acc, fr.mul(S(vp), fr.sub(poly, S(ev))))
        vp = fr.mul(vp, v)
    w_z = fr.mul(acc, fr.batch_inv(fr.sub(xvals, S(zeta))))
    acc2 = fr.sub(z, S(zw_ev))
    if lookup is not None:
        vp = v
        for poly, ev in (
            (lookup["t"], lookup["t_w_ev"]), (lookup["h1"], lookup["h1_w_ev"]),
            (lookup["h2"], lookup["h2_w_ev"]), (lookup["z2"], lookup["z2_w_ev"]),
        ):
            acc2 = fr.add(acc2, fr.mul(S(vp), fr.sub(poly, S(ev))))
            vp = fr.mul(vp, v)
    w_zw = fr.mul(acc2, fr.batch_inv(fr.sub(xvals, S(zeta_w))))
    return r_big, w_z, w_zw


def _coset_lift(coeffs, offset, n: int):
    """Monomial coefficients [16, *batch, P, m], m <= 4n (n + 3 for
    blinded rows), -> values on the offset 4n coset [16, *batch, P, 4n];
    offset [16, *batch]."""
    m = coeffs.shape[-1]
    pw = _ntt.scalar_powers(offset, m)
    scaled = fr.mul(coeffs, pw[..., None, :])
    pad = torch.zeros(coeffs.shape[:-1] + (4 * n - m,), dtype=DTYPE, device=coeffs.device)
    return _ntt.ntt(torch.cat([scaled, pad], dim=-1))


def _vanilla_rows(a, b, c, pi, z, selectors, sigmas):
    """Round 3's 15 vanilla rows [16, *batch, 15, n]: a, b, c, pi, the five
    selectors, z, z(wX), the three sigmas and L_0.  a, b, c, pi, z are
    [16, *batch, n]; selectors [16, 5, n] and sigmas [16, 3, n] are the
    circuit's, shared by every batch entry."""
    shape = a.shape[:-1]
    n = a.shape[-1]
    l0 = torch.zeros((NLIMBS, 1, n), dtype=DTYPE, device=a.device)
    l0[:, 0, 0] = fr.const("ONE_MONT", a.device)

    def shared(rows):
        lead = (1,) * (len(shape) - 1)
        return rows.reshape((NLIMBS,) + lead + rows.shape[1:]).expand(shape + rows.shape[1:])

    return torch.cat(
        [
            torch.stack([a, b, c, pi], dim=-2),
            shared(selectors),
            torch.stack([z, _shift1(z)], dim=-2),
            shared(sigmas),
            shared(l0),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# Prover.
# ---------------------------------------------------------------------------

class Prover:
    def __init__(
        self,
        setup: Setup,
        program: Program,
        debug: bool = False,
        config=None,
        device="cuda",
    ):
        from .config import ProverConfig
        from .utils.profiling import Timings

        self.device = resolve_device(device)
        if setup.device != self.device or program.device != self.device:
            raise ValueError(
                f"Prover on {self.device}: setup is on {setup.device}, "
                f"program on {program.device}"
            )
        self.config = config or ProverConfig(debug_checks=debug)
        mesh = self.config.mesh
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"Prover on {self.device}: its mesh computes on {mesh.device}")
        self.group_order = program.group_order
        self.setup = setup
        self.program = program
        self.pk: CommonPreprocessedInput = program.common_preprocessed_input()
        self.debug = self.config.debug_checks
        self.timings = Timings(self.device)
        self._custom = program.has_custom_gates
        self._lookup = program.has_lookups
        self._blind = program.blinding_rows > 0
        self._sharded = mesh is not None and self._mesh_shardable()
        self._mesh_msm = None
        if self._blind:
            # Z (and with lookups h1, h2, Z2) gains a Z_H-multiple of degree
            # n + 2, so those commits and the openings need 3 more powers.
            assert setup.msm_engine.n >= self.group_order + 3, (
                "ZK blinding requires an SRS with at least group_order + 3 "
                "G1 powers"
            )
        # Round-1 witness plan: the distinct variables in order of first
        # appearance, the None wire as one zero slot after them, and each
        # wire's slot as a device index [3, m], so each proof encodes every
        # distinct witness value once on the host and the device gathers
        # the A/B/C columns.
        wires = program.wires()
        var_ids: dict = {}
        for w in wires:
            for v in (w.L, w.R, w.O):
                if v is not None and v not in var_ids:
                    var_ids[v] = len(var_ids)
        order = list(var_ids)
        var_ids[None] = len(order)
        self._var_order = order
        # itemgetter of one key returns the bare value, not a tuple.
        self._var_values = (
            operator.itemgetter(*order) if len(order) > 1 else lambda w: [w[v] for v in order]
        )
        self._wire_idx = torch.tensor(
            [
                [var_ids[w.L] for w in wires],
                [var_ids[w.R] for w in wires],
                [var_ids[w.O] for w in wires],
            ],
            dtype=torch.int64, device=self.device,
        )
        self._public_vars = program.get_public_assignments()
        pk = self.pk
        self._selector_stack = torch.stack(
            [pk.QL.values, pk.QR.values, pk.QM.values, pk.QO.values, pk.QC.values],
            dim=1,
        )
        self._sigma_stack = torch.stack([pk.S1.values, pk.S2.values, pk.S3.values], dim=1)
        # Round 3's coset stack: 15 vanilla rows, QCUBE, then LOOKUP_ROWS.
        self._lookup_base = 16 if self._custom else 15
        if self._lookup:
            # PlonKup static tables: the padded table as host ints (for the
            # sorted concatenation) and as a set, and the lookup rows with
            # the variable each one queries.
            self._t_last = pk.t_last
            self._tbl_ints = pk.TBL.to_ints()
            self._tbl_set = set(self._tbl_ints)
            self._lookup_rows = [
                (i, c.wires.L)
                for i, c in enumerate(program.constraints)
                if c.coeffs.get("$lookup")
            ]

    def _mesh_shardable(self) -> bool:
        """The mesh rounds need n = n1 * n2 with n1 and n2 divisible by the
        axis size.  Cube-gate and lookup circuits shard like vanilla ones
        (the extra rows ride the same chain); ZK-blinded circuits take the
        single-device rounds, as in the JAX package (the sharded chain does
        not carry the Z_H-multiple coefficient deltas)."""
        from .parallel.sharded import _factor

        if self._blind:
            return False
        try:
            _factor(self.group_order, self.config.mesh.shape[self.config.mesh_axis])
        except ValueError:
            return False
        return True

    @property
    def _commit_engine(self):
        """The mesh-sharded commit engine in mesh mode, the setup's
        single-device engine otherwise."""
        if not self._sharded:
            return self.setup.msm_engine
        if self._mesh_msm is None:
            from .parallel.sharded import MeshMSM

            self._mesh_msm = MeshMSM(
                self.setup.msm_engine, self.config.mesh, self.config.mesh_axis,
                n=self.group_order,
            )
        return self._mesh_msm

    def _intt(self, stack) -> torch.Tensor:
        """Lagrange stack [16, B, k, n] -> monomial coefficients; in mesh
        mode (B = 1) length-sharded across the mesh."""
        if not self._sharded:
            return _ntt.ntt(stack, inverse=True)
        from .parallel.sharded import sharded_intt

        return sharded_intt(self.config.mesh, self.config.mesh_axis, stack[:, 0])[:, None]

    def _col(self, values) -> torch.Tensor:
        """Per-proof host scalars -> [16, B] Montgomery limbs on the
        prover's device."""
        return to_device(fr.to_mont_host_many(values), self.device)

    def _shared(self, rows) -> torch.Tensor:
        """A circuit row [16, n] as [16, B, n]: the same for every proof."""
        return rows[:, None, :].expand(NLIMBS, self._nb, self.group_order)

    def _commits(self, polys):
        """Per-proof lists of monomial coefficient rows [16, m] -> per-proof
        lists of host affine points: every commit of the round in one
        commit_batch, one host fetch."""
        points = self._commit_engine.commit_batch([p for row in polys for p in row])
        k = len(polys[0])
        return [points[i * k : (i + 1) * k] for i in range(len(polys))]

    @staticmethod
    def _rows(stack):
        """A coefficient stack [16, B, count, m] -> per-proof row lists."""
        return [[stack[:, i, j, :] for j in range(stack.shape[2])] for i in range(stack.shape[1])]

    def prove(self, witness: dict) -> Proof:
        return self._prove_batch([witness])[0]

    def _prove_batch(self, witnesses: list[dict]) -> list[Proof]:
        """Proofs of B witnesses of this circuit.  Each round runs once over
        [16, B, ...] tensors (B = 1 for `prove`) and commits all B proofs'
        polynomials in one commit_batch; each proof keeps its own
        Fiat-Shamir transcript on the host, so proof i is the one `prove`
        gives for witness i."""
        if self._sharded and len(witnesses) != 1:
            raise ValueError(
                "a length-sharded Prover proves one witness at a time; "
                "BatchProver(mesh=...) shards a batch"
            )
        transcripts = [Transcript(b"plonk") for _ in witnesses]
        # Like the reference, pk and PI are not absorbed — required for
        # bit-identical challenge streams.
        self._nb = len(witnesses)

        with self.timings.section("round_1"):
            msg_1 = self.round_1(witnesses)
        self.beta, self.gamma = zip(*(t.round_1(m) for t, m in zip(transcripts, msg_1)))
        if self._lookup:
            self.delta = [t.delta for t in transcripts]
            self.epsilon = [t.epsilon for t in transcripts]

        with self.timings.section("round_2"):
            msg_2 = self.round_2()
        self.alpha, self.fft_cofactor = zip(*(t.round_2(m) for t, m in zip(transcripts, msg_2)))

        with self.timings.section("round_3"):
            msg_3 = self.round_3()
        self.zeta = [t.round_3(m) for t, m in zip(transcripts, msg_3)]

        with self.timings.section("round_4"):
            msg_4 = self.round_4()
        self.v = [t.round_4(m) for t, m in zip(transcripts, msg_4)]

        with self.timings.section("round_5"):
            msg_5 = self.round_5()
        # Round 3's coset stack is the largest tensor of a proof: free it.
        self._bigs = self._xvals = self._t_coeffs = self._r3 = None
        return [Proof(*msgs) for msgs in zip(msg_1, msg_2, msg_3, msg_4, msg_5)]

    # -- the JAX package's helpers, on the last proof's challenges -------
    def _last(self, name: str):
        """The challenge `name` of the last proof; the prover keeps one per
        proof of a batch, so these helpers refuse after a batch of B > 1."""
        values = getattr(self, name)
        if len(values) != 1:
            raise ValueError(f"the prover last ran a batch of {len(values)} proofs")
        return values[0]

    def fft_expand(self, p: Polynomial) -> Polynomial:
        return p.to_coset_extended_lagrange(self._last("fft_cofactor"))

    def expanded_evals_to_coeffs(self, p: Polynomial) -> Polynomial:
        return p.coset_extended_lagrange_to_coeffs(self._last("fft_cofactor"))

    def rlc(self, t1, t2):
        return t1 + t2 * self._last("beta") + self._last("gamma")

    # -- round 1: wire polynomials ---------------------------------------
    def _lookup_columns(self, witness: dict) -> np.ndarray:
        """PlonKup's query column f (the queried value on lookup rows,
        t_last elsewhere) and the halves h1, h2 of s = sort_t(f[0..n-2] ++
        t), built on the host: raw limbs int32[16, 3, n]."""
        from .plonkup import sorted_by_table

        n = self.group_order
        fvals = [int(self._t_last)] * n
        for row, var in self._lookup_rows:
            val = int(witness[var]) % FR_MOD
            if val not in self._tbl_set:
                raise ValueError(f"lookup witness {var}={val} not in the table")
            fvals[row] = val
        s = sorted_by_table(fvals[: n - 1], self._tbl_ints)
        return encode_ints(fvals + s[:n] + s[n - 1 :]).reshape(NLIMBS, 3, n)

    def _witness_columns(self, witnesses: list[dict]):
        """Round 1's Lagrange columns of B witnesses, Montgomery limbs on
        the device: A, B, C (and with lookups f, h1, h2) [16, B, 3 (+3), n]
        and PI (-public input on its row, 0 elsewhere) [16, B, n].

        The host reduces each distinct witness value mod p and encodes it
        once, 32 little-endian bytes, all B proofs in one buffer and one
        upload; the device widens the bytes to limbs and gathers A, B, C
        over the wire plan.  With blinding rows, the last t rows of each
        wire column take fresh random values (selectors are zero and sigma
        the identity there, so any values satisfy the constraints).  The
        witnesses are only read."""
        nb, n, t = len(witnesses), self.group_order, self.program.blinding_rows
        slots = len(self._var_order) + 1
        with self.timings.section("round_1_witness_host"):
            get = self._var_values
            buf = bytearray().join(
                [(int(x) % FR_MOD).to_bytes(32, "little") for w in witnesses for x in (*get(w), 0)]
            )
            tails = encode_ints(_blinders(3 * t * nb)) if t else None
            pi = fr.to_mont_host_many(
                [(-int(w[v])) % FR_MOD for w in witnesses for v in self._public_vars]
            )
        limbs = torch.frombuffer(buf, dtype=torch.int16).to(self.device)
        limbs = (limbs.to(DTYPE) & LIMB_MASK).view(nb, slots, NLIMBS).permute(2, 0, 1)
        raw = torch.zeros((NLIMBS, nb, 3, n), dtype=DTYPE, device=self.device)
        raw[..., : self._wire_idx.shape[1]] = limbs[:, :, self._wire_idx]
        if t:
            raw[..., n - t :] = to_device(tails, self.device).view(NLIMBS, nb, 3, t)
        if self._lookup:
            with self.timings.section("round_1_lookup_host"):
                lk = np.stack([self._lookup_columns(w) for w in witnesses], axis=1)
            raw = torch.cat([raw, to_device(lk, self.device)], dim=2)
        pi_cols = torch.zeros((NLIMBS, nb, n), dtype=DTYPE, device=self.device)
        npub = len(self._public_vars)
        pi_cols[..., :npub] = to_device(pi, self.device).view(NLIMBS, nb, npub)
        return fr.to_mont(raw), pi_cols

    def round_1(self, witnesses: list[dict]) -> list[Message1]:
        cols, self.PI = self._witness_columns(witnesses)  # [16, B, 3 (+3), n], [16, B, n]
        self.A, self.B, self.C = (cols[:, :, i, :] for i in range(3))
        polys = self._rows(self._intt(cols))
        if self._lookup:
            self.F, self.H1, self.H2 = (cols[:, :, i, :] for i in range(3, 6))
            if self._blind:
                # The lookup identities pin f on every row and h1, h2 as
                # the sorted multiset, so random rows cannot hide them:
                # Z_H-multiples do, 2 blinders for f (opened at zeta), 3
                # for h1 and h2 (opened at zeta and zeta * omega).
                self._lk_blind = []
                for row in polys:
                    blinds = (_blinders(2), _blinders(3), _blinders(3))
                    self._lk_blind.append(blinds)
                    row[3:] = [_zh_blinded(p, r) for p, r in zip(row[3:], blinds)]
        # One commit_batch for A, B, C (and f, h1, h2): one host fetch.
        points = self._commits(polys)
        if self.debug:
            for i in range(self._nb):
                self._check_round_1(i)
        return [Message1(*p[:3], *(p[3:] if self._lookup else (None, None, None))) for p in points]

    def _check_round_1(self, i: int):
        """Debug: proof i's gate constraints, and with lookups its f."""
        pk = self.pk
        A, B, C, PI = (
            Polynomial(x[:, i, :], Basis.LAGRANGE) for x in (self.A, self.B, self.C, self.PI)
        )
        gate = A * pk.QL + B * pk.QR + A * B * pk.QM + C * pk.QO + PI + pk.QC
        if self._custom:
            gate = gate + A * A * A * pk.QCUBE
        assert gate == Polynomial.zeros(self.group_order, device=self.device), (
            "gate constraints violated"
        )
        if self._lookup:
            t_last = int(self._t_last)
            f_ints = fr.from_mont_host_many(self.F[:, i, :])
            assert all(
                f == (a if q else t_last)
                for f, q, a in zip(f_ints, pk.QK.to_ints(), A.to_ints())
            ), "query polynomial f malformed"

    # -- round 2: permutation grand product ------------------------------
    def round_2(self) -> list[Message2]:
        n = self.group_order
        beta, gamma = self._col(self.beta), self._col(self.gamma)
        if self._sharded:
            from .parallel.sharded import sharded_round2

            stack = torch.cat([torch.stack([self.A, self.B, self.C], dim=2)[:, 0], self._sigma_stack], dim=1)
            z, z_last = sharded_round2(
                self.config.mesh, self.config.mesh_axis, stack, beta[:, 0], gamma[:, 0]
            )
            z, z_last = z[:, None], z_last[:, None]
        else:
            s1, s2, s3 = (self._sigma_stack[:, None, k, :] for k in range(3))
            z, z_last = _perm_grand_product(
                self.A, self.B, self.C, s1, s2, s3,
                _ntt._roots_impl(n, False, self.device)[:, None, :], beta, gamma,
            )
        if self.debug:
            assert set(fr.from_mont_host_many(z_last)) == {1}, "grand product does not close"
        self.Z = z
        rows = [z]
        if self._lookup:
            z2, z2_last = _lookup_z2(
                self.F, self.pk.TBL.values[:, None, :], self.H1, self.H2,
                self._col(self.delta), self._col(self.epsilon),
            )
            if self.debug:
                assert set(fr.from_mont_host_many(z2_last)) == {1}, (
                    "lookup grand product does not close"
                )
            self.Z2 = z2
            rows.append(z2)
        polys = self._rows(self._intt(torch.stack(rows, dim=2)))
        if self._blind:
            # Z' = Z + r(X) Z_H(X) with r of degree 2 equals Z on the domain,
            # but hides the commitment and the zeta * omega opening: random
            # rows cannot, because sigma is the identity there (their
            # ratios are 1).  Z2 likewise, with blinders of its own.
            self._z_blind, self._z2_blind = [], []
            for row in polys:
                blinds = [_blinders(3) for _ in row]
                self._z_blind.append(blinds[0])
                self._z2_blind.append(blinds[-1])
                row[:] = [_zh_blinded(p, r) for p, r in zip(row, blinds)]
        # One commit_batch for Z (and Z2): one host fetch.
        return [Message2(*p) for p in self._commits(polys)]

    # -- round 3: quotient polynomial ------------------------------------
    def _lookup_stack(self) -> torch.Tensor:
        """Round 3's 11 PlonKup rows in LOOKUP_ROWS order, [16, B, 11, n]."""
        n = self.group_order
        ln = torch.zeros((NLIMBS, n), dtype=DTYPE, device=self.device)
        ln[:, n - 1] = fr.const("ONE_MONT", self.device)
        tbl = self.pk.TBL.values
        h1, h2, z2 = self.H1, self.H2, self.Z2
        return torch.stack(
            [
                self.F, self._shared(tbl), self._shared(_shift1(tbl)), h1, _shift1(h1),
                h2, _shift1(h2), z2, _shift1(z2), self._shared(self.pk.QK.values),
                self._shared(ln),
            ],
            dim=2,
        )

    def _blind_deltas(self, rows: int):
        """Round 3's coefficient deltas (dlo, dhi) [16, B, rows, 3] that add
        each blinded row's r(X) Z_H(X) after the inverse NTT: -r_j at X^j,
        r_j at X^(n+j); the omega-shifted rows p(wX) take r_j * w^j.  Z
        (rows 9, 10) and, with lookups, f, h1, h1(wX), h2, h2(wX), Z2 and
        Z2(wX); zero elsewhere."""
        root = Fr.root_of_unity(self.group_order)
        base = self._lookup_base
        lo, hi = [], []
        for i in range(self._nb):
            lo_i = [[0] * 3 for _ in range(rows)]
            hi_i = [[0] * 3 for _ in range(rows)]

            def put(row, blinders, shifted=False):
                r = [int(Fr(v) * root**j) if shifted else v for j, v in enumerate(blinders)]
                r += [0] * (3 - len(r))
                lo_i[row] = [(-v) % FR_MOD for v in r]
                hi_i[row] = r

            put(9, self._z_blind[i])
            put(10, self._z_blind[i], shifted=True)
            if self._lookup:
                rf, rh1, rh2 = self._lk_blind[i]
                put(base + LOOKUP_ROWS.index("f"), rf)
                put(base + LOOKUP_ROWS.index("h1"), rh1)
                put(base + LOOKUP_ROWS.index("h1s"), rh1, shifted=True)
                put(base + LOOKUP_ROWS.index("h2"), rh2)
                put(base + LOOKUP_ROWS.index("h2s"), rh2, shifted=True)
                put(base + LOOKUP_ROWS.index("z2"), self._z2_blind[i])
                put(base + LOOKUP_ROWS.index("z2s"), self._z2_blind[i], shifted=True)
            lo += sum(lo_i, [])
            hi += sum(hi_i, [])
        return tuple(
            to_device(fr.to_mont_host_many(d), self.device).reshape(NLIMBS, self._nb, rows, 3)
            for d in (lo, hi)
        )

    def round_3(self) -> list[Message3]:
        n, nb = self.group_order, self._nb
        offs = self.fft_cofactor
        rows = [
            _vanilla_rows(
                self.A, self.B, self.C, self.PI, self.Z,
                self._selector_stack, self._sigma_stack,
            )
        ]
        if self._custom:
            rows.append(self._shared(self.pk.QCUBE.values)[:, :, None, :])
        if self._lookup:
            rows.append(self._lookup_stack())
        polys = torch.cat(rows, dim=2)  # [16, B, 15 (+1) (+11), n]
        if self._sharded:
            quot, qcoeffs = self._round_3_sharded(polys)
        else:
            quot, qcoeffs = self._round_3_single(polys)
        # T stays in coefficient form: round 5 lifts it to the coset again.
        self._t_coeffs = qcoeffs[..., : 3 * n].reshape(NLIMBS, nb, 3, n)

        if self.debug:
            t_lag = _ntt.ntt(self._t_coeffs)  # [16, B, 3, n]
            for i, off in enumerate(offs):
                tail = fr.from_mont_host_many(qcoeffs[:, i, 3 * n :])
                assert tail == [0] * n, "quotient degree >= 3n"
                t1, t2, t3 = (Polynomial(t_lag[:, i, k, :], Basis.LAGRANGE) for k in range(3))
                lhs = (
                    t1.barycentric_eval(off)
                    + t2.barycentric_eval(off) * off**n
                    + t3.barycentric_eval(off) * off ** (n * 2)
                )
                assert lhs == Fr(fr.from_mont_host(quot[:, i, 0])), "T split mismatch"

        return [Message3(*p) for p in self._commits(self._rows(self._t_coeffs))]

    def _round_3_single(self, polys):
        """Round 3's coset chain on this device: (QUOT on the 4n coset,
        its coefficients), each [16, B, 4n]; keeps the coset stack and X
        values for round 5."""
        n, offs = self.group_order, self.fft_cofactor
        offset = self._col(offs)
        coeffs = _ntt.ntt(polys, inverse=True)
        del polys
        if self._blind:
            # The blinded rows' Z_H-multiples raise their degree to n + 2:
            # the stack grows by 3 coefficients before the coset lift.
            dlo, dhi = self._blind_deltas(coeffs.shape[2])
            coeffs = torch.cat([fr.add(coeffs[..., :3], dlo), coeffs[..., 3:], dhi], dim=-1)
        bigs = _coset_lift(coeffs, offset, n)  # [16, B, rows, 4n]
        del coeffs
        qroots, w4p = _coset_x_consts_impl(n, self.device)
        xvals, zh_inv, _zh = _coset_x_impl(offset, self._col([o**n for o in offs]), qroots, w4p)
        quot = _quotient_impl(
            *[bigs[:, :, i, :] for i in range(15)], xvals, zh_inv,
            self._col(self.beta), self._col(self.gamma), self._col(self.alpha),
            qcube=self._coset_qcube(bigs), lookup=self._coset_lookup(bigs),
        )
        self._bigs = bigs
        self._xvals = xvals
        return quot, _ntt.coset_to_coeffs(quot, self._col([Fr(1) / o for o in offs]))

    def _round_3_sharded(self, polys):
        """Round 3's coset chain length-sharded over the mesh (B = 1):
        (QUOT, read only by the debug checks, else None; its coefficients
        [16, 1, 4n]).  Keeps the sharded output, whose permuted blocks
        round 5 consumes."""
        from .parallel.sharded import sharded_round3

        lookup_scalars = None
        if self._lookup:
            lookup_scalars = (
                self._col(self.delta)[:, 0], self._col(self.epsilon)[:, 0],
                fr.scalar(self._t_last, self.device),
            )
        self._r3 = sharded_round3(
            self.config.mesh, self.config.mesh_axis, polys[:, 0],
            self._col(self.beta)[:, 0], self._col(self.gamma)[:, 0], self._col(self.alpha)[:, 0],
            self.fft_cofactor[0], custom=self._custom, lookup_scalars=lookup_scalars,
        )
        quot = self._r3.quot[:, None] if self.debug else None
        return quot, self._r3.qcoeffs[:, None]

    def _coset_qcube(self, bigs):
        """The QCUBE row of round 3's coset stack, or None."""
        return bigs[:, :, 15, :] if self._custom else None

    def _coset_lookup(self, bigs):
        """Round 3's PlonKup inputs: the coset rows of LOOKUP_ROWS and the
        scalar limbs delta, epsilon, t_last, w^{n-1}; None without lookups."""
        if not self._lookup:
            return None
        lookup = {name: bigs[:, :, self._lookup_base + i, :] for i, name in enumerate(LOOKUP_ROWS)}
        n, nb = self.group_order, self._nb
        lookup.update(
            delta=self._col(self.delta), epsilon=self._col(self.epsilon),
            tlast=self._col([self._t_last] * nb),
            gl=self._col([Fr.root_of_unity(n) ** (n - 1)] * nb),
        )
        return lookup

    # -- round 4: openings -------------------------------------------------
    def round_4(self) -> list[Message4]:
        n, nb = self.group_order, self._nb
        root = Fr.root_of_unity(n)
        rows = [
            self.A, self.B, self.C, self._shared(self._sigma_stack[:, 0, :]),
            self._shared(self._sigma_stack[:, 1, :]), self.Z,
        ]
        shifted = [False] * 5 + [True]
        if self._lookup:
            # f, t at zeta; t, h1, h2 at both; z2 at zeta*omega only
            # (z2(zeta) and q_K(zeta) are linearized away in round 5).
            tbl = self._shared(self.pk.TBL.values)
            rows += [self.F, tbl, tbl, self.H1, self.H1, self.H2, self.H2, self.Z2]
            shifted += [False, False, True, False, True, False, True, True]
        k = len(rows)
        points = self._col([zt * root if s else zt for zt in self.zeta for s in shifted])
        values = torch.stack(rows, dim=2).reshape(NLIMBS, nb * k, n)
        if self._sharded:
            from .parallel.sharded import sharded_round4

            evs = sharded_round4(self.config.mesh, self.config.mesh_axis, values, points)
        else:
            evs = _barycentric_batch(values, points, n)
        evs = fr.from_mont_host_many(evs)
        self.evals = [[Fr(v) for v in evs[i * k : (i + 1) * k]] for i in range(nb)]
        if self._blind:
            for i in range(nb):
                self._blind_evals(i)
        if not self._lookup:
            return [Message4(*e) for e in self.evals]
        keys = ("f", "t", "t_w", "h1", "h1_w", "h2", "h2_w", "z2_w")
        self.lookup_evals = [dict(zip(keys, e[6:])) for e in self.evals]
        return [Message4(*e[:6], lookup_evals=lk) for e, lk in zip(self.evals, self.lookup_evals)]

    def _blind_evals(self, i: int):
        """Proof i's published openings under blinding: the Lagrange values
        are the unblinded polynomials'; each blinded one adds r(pt) *
        Z_H(pt), with Z_H(zeta * w) = Z_H(zeta) = zeta^n - 1 as w^n = 1.
        evals[6:] are f, t, t_w, h1, h1_w, h2, h2_w, z2_w."""
        n, zeta = self.group_order, self.zeta[i]
        zh = zeta**n - 1
        zw = zeta * Fr.root_of_unity(n)
        evals = self.evals[i]

        def rev(blinders, pt):
            acc = Fr(0)
            for c in reversed(blinders):
                acc = acc * pt + Fr(c)
            return acc * zh

        evals[5] += rev(self._z_blind[i], zw)
        if self._lookup:
            rf, rh1, rh2 = self._lk_blind[i]
            for j, r, pt in (
                (6, rf, zeta), (9, rh1, zeta), (10, rh1, zw),
                (11, rh2, zeta), (12, rh2, zw), (13, self._z2_blind[i], zw),
            ):
                evals[j] += rev(r, pt)

    # -- round 5: linearization + opening proofs --------------------------
    def _round5_lookup_scalars(self, root):
        """Round 5's PlonKup scalars, [16, B] each: the linearization
        scalars and the eight openings; None without lookups."""
        if not self._lookup:
            return None
        from .plonkup import linearization_scalars

        per_proof = []
        for i in range(self._nb):
            e = dict(self.lookup_evals[i])
            e["a"] = self.evals[i][0]
            c_z2, c_h1, c_qk, c_const = linearization_scalars(
                self.group_order, self.alpha[i], self.zeta[i], self.delta[i],
                self.epsilon[i], e, self._t_last, root,
            )
            scalars = dict(c_z2=c_z2, c_h1=c_h1, c_qk=c_qk, c_const=c_const)
            opened = ("f", "t", "h1", "h2", "t_w", "h1_w", "h2_w", "z2_w")
            scalars.update({f"{k}_ev": e[k] for k in opened})
            per_proof.append(scalars)
        return {k: self._col([s[k] for s in per_proof]) for k in per_proof[0]}

    def round_5(self) -> list[Message5]:
        n = self.group_order
        root = Fr.root_of_unity(n)
        zetas, offs, col = self.zeta, self.fft_cofactor, self._col
        zh_ev = [zt**n - 1 for zt in zetas]
        zeta = col(zetas)
        pi_ev = fr.from_mont_host_many(_barycentric_batch(self.PI, zeta, n))
        scalars = [
            *(col([e[k] for e in self.evals]) for k in range(6)),
            col(pi_ev), col([h / (n * (zt - 1)) for h, zt in zip(zh_ev, zetas)]), col(zh_ev),
            col([zt**n for zt in zetas]), col([zt ** (2 * n) for zt in zetas]),
            col(self.beta), col(self.gamma), col(self.alpha),
            zeta, col([zt * root for zt in zetas]), col(self.v),
        ]
        cube_ev = col([e[0] ** 3 for e in self.evals]) if self._custom else None
        lookup_scalars = self._round5_lookup_scalars(root)

        if self._sharded:
            from .parallel.sharded import sharded_round5

            r_big, w_coeffs = sharded_round5(
                self.config.mesh, self.config.mesh_axis, self._r3, self._t_coeffs[:, 0],
                [s[:, 0] for s in scalars], offs[0], custom=self._custom,
                cube_ev=None if cube_ev is None else cube_ev[:, 0],
                lookup_scalars=None if lookup_scalars is None
                else {k: v[:, 0] for k, v in lookup_scalars.items()},
            )
            r_big, w_coeffs = r_big[:, None], w_coeffs[:, None]
        else:
            # Expand T1..T3 to the coset (batched).
            t_big = _coset_lift(self._t_coeffs, col(offs), n)  # [16, B, 3, 4n]
            lookup = None
            if lookup_scalars is not None:
                lookup = {
                    name: self._bigs[:, :, self._lookup_base + i, :]
                    for i, name in enumerate(LOOKUP_ROWS)
                    if name in ("f", "t", "h1", "h2", "z2", "qk")
                }
                lookup.update(lookup_scalars)
            r_big, w_z, w_zw = _linearization_impl(
                [self._bigs[:, :, i, :] for i in range(15)],
                *(t_big[:, :, k, :] for k in range(3)), self._xvals, *scalars,
                qcube=self._coset_qcube(self._bigs), cube_ev=cube_ev, lookup=lookup,
            )
            del t_big
            offinv = col([Fr(1) / o for o in offs])
            w_coeffs = _ntt.coset_to_coeffs(torch.stack([w_z, w_zw], dim=2), offinv[..., None])
        # A blinded Z' (degree n + 2) raises the opening quotients to n + 1.
        wlen = n + 3 if self._blind else n

        if self.debug:
            for i, (off, zt) in enumerate(zip(offs, zetas)):
                r_lag = Polynomial(r_big[:, i, :], Basis.LAGRANGE)
                r_coeffs = r_lag.coset_extended_lagrange_to_coeffs(off)
                if self._blind:
                    # R has degree n + 2 under blinding: Horner over all of it.
                    r_at_zeta = Fr(0)
                    for c in reversed(r_coeffs.to_ints()):
                        r_at_zeta = r_at_zeta * zt + Fr(c)
                else:
                    r_poly = Polynomial(r_coeffs.values[:, :n], Basis.MONOMIAL).fft()
                    r_at_zeta = r_poly.barycentric_eval(zt)
                assert r_at_zeta == 0, "R(zeta) != 0"
                for j, name in enumerate(("W_z", "W_zw")):
                    tail = fr.from_mont_host_many(w_coeffs[:, i, j, wlen:])
                    assert tail == [0] * (4 * n - wlen), f"{name} degree too large"

        return [Message5(*p) for p in self._commits(self._rows(w_coeffs[..., :wlen]))]
