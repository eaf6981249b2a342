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
selector; the quotient gains q_cube * A^3 and R gains QCUBE * a_eval^3) and
PlonKup lookups (plonkup.py: round 1 also commits f, h1, h2, round 2 the
lookup grand product Z2, round 3 folds five identities in at alpha^3 ...
alpha^7, round 4 opens eight more values, round 5 linearizes them).  ZK
blinding rows (ROADMAP Queue 1, item 3) and the mesh-sharded rounds (item
6) raise NotImplementedError naming that item; the batch prover (item 5)
comes with its own slice.

`debug=True` enables the internal invariant checks (gate constraint, Z
closure, quotient degree, T split, R(zeta) = 0, W degrees; with lookups
also the query column f and the Z2 closure).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fields import Fr, FR_MOD
from .frontend import Program, CommonPreprocessedInput
from .kzg import Setup
from .ops.limbs import fr, NLIMBS, DTYPE, encode_ints, to_device, resolve_device
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

def _rlc(x, y, beta, gamma):
    return fr.add(fr.add(x, fr.mul(beta, y)), gamma)


def _prefix_product(f, g):
    """Z[0]=1; Z[i] = prod_{j<i} f[j]/g[j]; also returns the closing value."""
    n = f.shape[-1]
    steps = max((n - 1).bit_length(), 1)
    pos = torch.arange(n, device=f.device)
    one = fr.const("ONE_MONT", f.device, 2)
    cf, cg = f, g
    for j in range(steps):
        shift = 1 << j
        valid = (pos >= shift)[None]
        inf = torch.where(valid, torch.roll(cf, shift, dims=-1), one)
        ing = torch.where(valid, torch.roll(cg, shift, dims=-1), one)
        cf, cg = fr.mul(inf, cf), fr.mul(ing, cg)
    z_all = fr.mul(cf, fr.batch_inv(cg))
    z_last = z_all[:, -1]
    z = torch.cat([one, z_all[:, :-1]], dim=-1)
    return z, z_last


def _shift1(values):
    """Lagrange values of p(omega X): a cyclic left rotation by one row."""
    return torch.roll(values, -1, dims=-1)


def _lookup_z2(f, t, h1, h2, delta, epsilon):
    """PlonKup round-2 companion: the lookup grand product Z2 over rows
    0..n-2, the wrap-around row's ratio set to 1 (identity (b') of
    plonkup.py excludes it through its (x - w^{n-1}) factor):
      num_i = (1+d)(e+f_i)(e(1+d) + t_i + d*t_{i+1})
      den_i = (e(1+d) + h1_i + d*h1_{i+1})(e(1+d) + h2_i + d*h2_{i+1})
    Returns (Z2 Lagrange values, closing value)."""
    n = f.shape[-1]
    one = fr.const("ONE_MONT", f.device, 2)
    d = delta[:, None]
    e = epsilon[:, None]
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
    """(X values, Z_H^-1 values, Z_H values) on the 4n coset."""
    xvals = fr.mul(offset[:, None], qroots)
    one = fr.const("ONE_MONT", offset.device, 2)
    zh = fr.sub(fr.mul(offset_n[:, None], w4p), one)
    return xvals, fr.batch_inv(zh), zh


# Round 3's 11 PlonKup rows, after the 15 vanilla rows and the optional
# QCUBE row ("s" = omega-shifted, ln = L_{n-1}).
LOOKUP_ROWS = ("f", "t", "ts", "h1", "h1s", "h2", "h2s", "z2", "z2s", "qk", "ln")


def _quotient_impl(
    a, b, c, pi, ql, qr, qm, qo, qc, z, zs, s1, s2, s3, l0, xvals, zh_inv,
    beta, gamma, alpha, qcube=None, lookup=None,
):
    """QUOT on the 4n coset (all inputs coset-extended, [16, 4n]).

    `qcube` (optional): the cube-gate selector on the coset; the gate gains
    q_cube * A^3 (degree 4n - 4, inside the 4n domain).

    `lookup` (optional, PlonKup): a dict with the coset-extended rows of
    LOOKUP_ROWS and the scalar limbs delta, epsilon, tlast and gl
    (= w^{n-1}); adds the five plookup identities weighted by alpha^3 ...
    alpha^7."""
    beta = beta[:, None]
    gamma = gamma[:, None]
    alpha = alpha[:, None]
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
    one = fr.const("ONE_MONT", a.device, 2)
    start = fr.mul(fr.mul(fr.mul(alpha, alpha), fr.sub(z, one)), l0)
    ident = fr.add(gate, fr.add(perm, start))
    if lookup is not None:
        lk = lookup
        delta = lk["delta"][:, None]
        eps = lk["epsilon"][:, None]
        od = fr.add(one, delta)                 # 1 + delta
        ed = fr.mul(eps, od)                    # epsilon * (1 + delta)
        xm = fr.sub(xvals, lk["gl"][:, None])   # x - w^{n-1}
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
        tl = fr.sub(lk["tlast"][:, None], lk["f"])
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
    total = _ntt._treesum(terms)
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
    S = lambda x: x[:, None]  # noqa: E731
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
    one = fr.const("ONE_MONT", a.device, 2)
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
    """Monomial coefficients [16, P, n] -> values on the offset 4n coset."""
    pw = _ntt.scalar_powers(offset, n)
    scaled = fr.mul(coeffs, pw[:, None, :])
    pad = torch.zeros(
        (NLIMBS, coeffs.shape[1], 3 * n), dtype=DTYPE, device=coeffs.device
    )
    return _ntt.ntt(torch.cat([scaled, pad], dim=2))


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
        if getattr(program, "blinding_rows", 0):
            raise NotImplementedError(
                "ZK blinding rows arrive with ROADMAP Queue 1, item 3"
            )
        if self.config.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded proving arrives with torch.distributed "
                "(ROADMAP Queue 1, item 6)"
            )
        self.group_order = program.group_order
        self.setup = setup
        self.program = program
        self.pk: CommonPreprocessedInput = program.common_preprocessed_input()
        self.debug = self.config.debug_checks
        self.timings = Timings(self.device)
        self._custom = program.has_custom_gates
        self._lookup = program.has_lookups
        # Round-1 witness gather plan: wire slot -> unique-variable id, so
        # each proof encodes every distinct witness value once and builds
        # the A/B/C columns with one numpy fancy-index.
        wires = program.wires()
        var_ids: dict = {}
        for w in wires:
            for v in (w.L, w.R, w.O):
                if v not in var_ids:
                    var_ids[v] = len(var_ids)
        self._var_order = list(var_ids)
        self._wire_idx = np.array(
            [
                [var_ids[w.L] for w in wires],
                [var_ids[w.R] for w in wires],
                [var_ids[w.O] for w in wires],
            ],
            dtype=np.int64,
        )
        pk = self.pk
        self._selector_stack = torch.stack(
            [pk.QL.values, pk.QR.values, pk.QM.values, pk.QO.values, pk.QC.values],
            dim=1,
        )
        self._s_stack = (pk.S1.values, pk.S2.values, pk.S3.values)
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

    def _s(self, x) -> torch.Tensor:
        """Fr -> [16] Montgomery limbs on the prover's device."""
        return fr.scalar(int(x), self.device)

    def _commits(self, coeffs, count: int):
        """Monomial coefficient stack [16, count, m] -> host affine points,
        with one host fetch for the whole round."""
        return self.setup.msm_engine.commit_batch(
            [coeffs[:, i, :] for i in range(count)]
        )

    def prove(self, witness: dict) -> Proof:
        transcript = Transcript(b"plonk")
        # Like the reference, pk and PI are not absorbed — required for
        # bit-identical challenge streams.
        witness = dict(witness)
        public_vars = self.program.get_public_assignments()
        n = self.group_order
        pi_arr = np.zeros((NLIMBS, n), dtype=np.int32)
        if public_vars:
            pi_arr[:, : len(public_vars)] = fr.to_mont_host_many(
                [(-int(witness[v])) % FR_MOD for v in public_vars]
            )
        self.PI = Polynomial(to_device(pi_arr, self.device), Basis.LAGRANGE)

        with self.timings.section("round_1"):
            msg_1 = self.round_1(witness)
        self.beta, self.gamma = transcript.round_1(msg_1)
        if self._lookup:
            self.delta, self.epsilon = transcript.delta, transcript.epsilon

        with self.timings.section("round_2"):
            msg_2 = self.round_2()
        self.alpha, self.fft_cofactor = transcript.round_2(msg_2)

        with self.timings.section("round_3"):
            msg_3 = self.round_3()
        self.zeta = transcript.round_3(msg_3)

        with self.timings.section("round_4"):
            msg_4 = self.round_4()
        self.v = transcript.round_4(msg_4)

        with self.timings.section("round_5"):
            msg_5 = self.round_5()
        return Proof(msg_1, msg_2, msg_3, msg_4, msg_5)

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

    def round_1(self, witness: dict) -> Message1:
        n = self.group_order
        if None not in witness:
            witness[None] = 0
        var_limbs = encode_ints(
            [int(witness[v]) % FR_MOD for v in self._var_order]
        )  # [16, n_vars]
        m = self._wire_idx.shape[1]
        abc_raw = np.zeros((NLIMBS, 3, n), dtype=np.int32)
        abc_raw[:, :, :m] = var_limbs[:, self._wire_idx]
        if self._lookup:
            with self.timings.section("round_1_lookup_host"):
                abc_raw = np.concatenate([abc_raw, self._lookup_columns(witness)], axis=1)
        cols = fr.to_mont(to_device(abc_raw, self.device))  # [16, 3 (+3), n]
        self.A = Polynomial(cols[:, 0, :], Basis.LAGRANGE)
        self.B = Polynomial(cols[:, 1, :], Basis.LAGRANGE)
        self.C = Polynomial(cols[:, 2, :], Basis.LAGRANGE)
        # One commit_batch for A, B, C (and f, h1, h2): one host fetch.
        points = self._commits(_ntt.ntt(cols, inverse=True), cols.shape[1])
        lk_points = (None, None, None)
        if self._lookup:
            self.F = Polynomial(cols[:, 3, :], Basis.LAGRANGE)
            self.H1 = Polynomial(cols[:, 4, :], Basis.LAGRANGE)
            self.H2 = Polynomial(cols[:, 5, :], Basis.LAGRANGE)
            lk_points = tuple(points[3:])

        if self.debug:
            gate = (
                self.A * self.pk.QL
                + self.B * self.pk.QR
                + self.A * self.B * self.pk.QM
                + self.C * self.pk.QO
                + self.PI
                + self.pk.QC
            )
            if self._custom:
                gate = gate + self.A * self.A * self.A * self.pk.QCUBE
            assert gate == Polynomial.zeros(n, device=self.device), "gate constraints violated"
            if self._lookup:
                t_last = int(self._t_last)
                assert all(
                    f == (a if q else t_last)
                    for f, q, a in zip(
                        self.F.to_ints(), self.pk.QK.to_ints(), self.A.to_ints()
                    )
                ), "query polynomial f malformed"
        return Message1(*points[:3], *lk_points)

    # -- round 2: permutation grand product ------------------------------
    def round_2(self) -> Message2:
        n = self.group_order
        roots = _ntt._roots_impl(n, False, self.device)
        beta, gamma = self._s(self.beta)[:, None], self._s(self.gamma)[:, None]
        a, b, c = self.A.values, self.B.values, self.C.values
        s1, s2, s3 = self._s_stack
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
        z, z_last = _prefix_product(f, g)
        if self.debug:
            assert fr.from_mont_host(z_last) == 1, "grand product does not close"
        self.Z = Polynomial(z, Basis.LAGRANGE)
        rows = [z]
        if self._lookup:
            z2, z2_last = _lookup_z2(
                self.F.values, self.pk.TBL.values, self.H1.values, self.H2.values,
                self._s(self.delta), self._s(self.epsilon),
            )
            if self.debug:
                assert fr.from_mont_host(z2_last) == 1, "lookup grand product does not close"
            self.Z2 = Polynomial(z2, Basis.LAGRANGE)
            rows.append(z2)
        # One commit_batch for Z (and Z2): one host fetch.
        points = self._commits(_ntt.ntt(torch.stack(rows, dim=1), inverse=True), len(rows))
        return Message2(*points)

    # -- round 3: quotient polynomial ------------------------------------
    def _lookup_stack(self) -> torch.Tensor:
        """Round 3's 11 PlonKup rows in LOOKUP_ROWS order, [16, 11, n]."""
        n = self.group_order
        ln = torch.zeros((NLIMBS, n), dtype=DTYPE, device=self.device)
        ln[:, n - 1] = fr.const("ONE_MONT", self.device)
        tbl, h1, h2, z2 = (
            self.pk.TBL.values, self.H1.values, self.H2.values, self.Z2.values
        )
        return torch.stack(
            [
                self.F.values, tbl, _shift1(tbl), h1, _shift1(h1),
                h2, _shift1(h2), z2, _shift1(z2), self.pk.QK.values, ln,
            ],
            dim=1,
        )

    def round_3(self) -> Message3:
        n = self.group_order
        off = self.fft_cofactor
        l0 = torch.zeros((NLIMBS, n), dtype=DTYPE, device=self.device)
        l0[:, 0] = fr.const("ONE_MONT", self.device)
        rows = [
            torch.stack(
                [self.A.values, self.B.values, self.C.values, self.PI.values], dim=1
            ),
            self._selector_stack,
            self.Z.values[:, None, :],
            _shift1(self.Z.values)[:, None, :],
            torch.stack(self._s_stack, dim=1),
            l0[:, None, :],
        ]  # 15 rows
        if self._custom:
            rows.append(self.pk.QCUBE.values[:, None, :])
        if self._lookup:
            rows.append(self._lookup_stack())
        polys = torch.cat(rows, dim=1)  # [16, 15 (+1) (+11), n]
        offset = self._s(off)
        bigs = _coset_lift(_ntt.ntt(polys, inverse=True), offset, n)
        del polys
        qroots, w4p = _coset_x_consts_impl(n, self.device)
        xvals, zh_inv, _zh = _coset_x_impl(offset, self._s(off**n), qroots, w4p)
        quot = _quotient_impl(
            *[bigs[:, i, :] for i in range(15)], xvals, zh_inv,
            self._s(self.beta), self._s(self.gamma), self._s(self.alpha),
            qcube=self._coset_qcube(bigs), lookup=self._coset_lookup(bigs),
        )
        qcoeffs = _ntt.coset_to_coeffs(quot, self._s(Fr(1) / off))  # [16, 4n]
        t_coeffs = qcoeffs[:, : 3 * n].reshape(NLIMBS, 3, n)
        self._t_lag = _ntt.ntt(t_coeffs)  # [16, 3, n]
        self._bigs = bigs
        self._xvals = xvals

        if self.debug:
            tail = fr.from_mont_host_many(qcoeffs[:, 3 * n :])
            assert tail == [0] * n, "quotient degree >= 3n"
            t1, t2, t3 = (
                Polynomial(self._t_lag[:, i, :], Basis.LAGRANGE) for i in range(3)
            )
            lhs = (
                t1.barycentric_eval(off)
                + t2.barycentric_eval(off) * off**n
                + t3.barycentric_eval(off) * off ** (n * 2)
            )
            assert lhs == Fr(fr.from_mont_host(quot[:, 0])), "T split mismatch"

        t_lo_1, t_mid_1, t_hi_1 = self._commits(t_coeffs, 3)
        return Message3(t_lo_1, t_mid_1, t_hi_1)

    def _coset_qcube(self, bigs):
        """The QCUBE row of round 3's coset stack, or None."""
        return bigs[:, 15, :] if self._custom else None

    def _coset_lookup(self, bigs):
        """Round 3's PlonKup inputs: the coset rows of LOOKUP_ROWS and the
        scalar limbs delta, epsilon, t_last, w^{n-1}; None without lookups."""
        if not self._lookup:
            return None
        lookup = {name: bigs[:, self._lookup_base + i, :] for i, name in enumerate(LOOKUP_ROWS)}
        n = self.group_order
        lookup.update(
            delta=self._s(self.delta), epsilon=self._s(self.epsilon),
            tlast=self._s(self._t_last), gl=self._s(Fr.root_of_unity(n) ** (n - 1)),
        )
        return lookup

    # -- round 4: openings -------------------------------------------------
    def round_4(self) -> Message4:
        n = self.group_order
        zeta = self.zeta
        root = Fr.root_of_unity(n)
        rows = [
            self.A.values, self.B.values, self.C.values,
            self._s_stack[0], self._s_stack[1], self.Z.values,
        ]
        zl, zwl = self._s(zeta), self._s(zeta * root)
        points = [zl] * 5 + [zwl]
        if self._lookup:
            # f, t at zeta; t, h1, h2 at both; z2 at zeta*omega only
            # (z2(zeta) and q_K(zeta) are linearized away in round 5).
            tbl = self.pk.TBL.values
            rows += [
                self.F.values, tbl, tbl, self.H1.values, self.H1.values,
                self.H2.values, self.H2.values, self.Z2.values,
            ]
            points += [zl, zl, zwl, zl, zwl, zl, zwl, zwl]
        evs = _barycentric_batch(torch.stack(rows, dim=1), torch.stack(points, dim=1), n)
        evals = [Fr(v) for v in fr.from_mont_host_many(evs)]
        (
            self.a_eval, self.b_eval, self.c_eval,
            self.s1_eval, self.s2_eval, self.z_shifted_eval,
        ) = evals[:6]
        if not self._lookup:
            return Message4(*evals)
        keys = ("f", "t", "t_w", "h1", "h1_w", "h2", "h2_w", "z2_w")
        self.lookup_evals = dict(zip(keys, evals[6:]))
        return Message4(*evals[:6], lookup_evals=self.lookup_evals)

    # -- round 5: linearization + opening proofs --------------------------
    def _round5_lookup(self, root):
        """Round 5's PlonKup inputs: the coset rows f, t, h1, h2, z2, qk,
        the linearization scalars and the eight openings; None without
        lookups."""
        if not self._lookup:
            return None
        from .plonkup import linearization_scalars

        e = dict(self.lookup_evals)
        e["a"] = self.a_eval
        c_z2, c_h1, c_qk, c_const = linearization_scalars(
            self.group_order, self.alpha, self.zeta, self.delta, self.epsilon, e,
            self._t_last, root,
        )
        lookup = {
            name: self._bigs[:, self._lookup_base + i, :] for i, name in enumerate(LOOKUP_ROWS)
            if name in ("f", "t", "h1", "h2", "z2", "qk")
        }
        scalars = dict(c_z2=c_z2, c_h1=c_h1, c_qk=c_qk, c_const=c_const)
        scalars.update({f"{k}_ev": e[k] for k in ("f", "t", "h1", "h2", "t_w", "h1_w", "h2_w", "z2_w")})
        lookup.update({k: self._s(x) for k, x in scalars.items()})
        return lookup

    def round_5(self) -> Message5:
        n = self.group_order
        zeta = self.zeta
        root = Fr.root_of_unity(n)
        off = self.fft_cofactor
        zh_ev = zeta**n - 1
        l0_ev = zh_ev / (n * (zeta - 1))
        pi_ev = self.PI.barycentric_eval(zeta)
        s = self._s

        # Expand T1..T3 to the coset (batched).
        t_big = _coset_lift(_ntt.ntt(self._t_lag, inverse=True), s(off), n)
        t1, t2, t3 = (t_big[:, i, :] for i in range(3))
        r_big, w_z, w_zw = _linearization_impl(
            [self._bigs[:, i, :] for i in range(15)], t1, t2, t3, self._xvals,
            s(self.a_eval), s(self.b_eval), s(self.c_eval),
            s(self.s1_eval), s(self.s2_eval), s(self.z_shifted_eval),
            s(pi_ev), s(l0_ev), s(zh_ev), s(zeta**n), s(zeta ** (2 * n)),
            s(self.beta), s(self.gamma), s(self.alpha),
            s(zeta), s(zeta * root), s(self.v),
            qcube=self._coset_qcube(self._bigs),
            cube_ev=s(self.a_eval**3) if self._custom else None,
            lookup=self._round5_lookup(root),
        )
        offinv = s(Fr(1) / off)
        w_z_coeffs = _ntt.coset_to_coeffs(w_z, offinv)
        w_zw_coeffs = _ntt.coset_to_coeffs(w_zw, offinv)

        if self.debug:
            r_coeffs = Polynomial(r_big, Basis.LAGRANGE).coset_extended_lagrange_to_coeffs(off)
            r_poly = Polynomial(r_coeffs.values[:, :n], Basis.MONOMIAL).fft()
            assert r_poly.barycentric_eval(zeta) == 0, "R(zeta) != 0"
            assert fr.from_mont_host_many(w_z_coeffs[:, n:]) == [0] * (3 * n), (
                "W_z degree too large"
            )
            assert fr.from_mont_host_many(w_zw_coeffs[:, n:]) == [0] * (3 * n), (
                "W_zw degree too large"
            )

        both = torch.stack([w_z_coeffs[:, :n], w_zw_coeffs[:, :n]], dim=1)
        W_z_1, W_zw_1 = self._commits(both, 2)
        return Message5(W_z_1, W_zw_1)
