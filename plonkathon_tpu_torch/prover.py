"""The 5-round PLONK prover on torch tensors (vanilla path).

Rounds and algebra match the JAX package's prover exactly, so proofs are
bit-identical (Merlin Fiat-Shamir is deterministic):

  1. wire polynomials A, B, C + commitments
  2. permutation grand product Z (log-depth prefix product) + commitment
  3. quotient on the 4n coset, split T1/T2/T3 + commitments
  4. openings at zeta / zeta*omega
  5. linearization R, opening proofs W_z, W_zw + commitments

Every field multiply goes through `FieldOps.mul` (the Montgomery-product
kernel on CUDA), every NTT stage through the butterfly kernel, and every
commitment through the msm2 pipeline; only the transcript crosses to the
host between rounds, and each round fetches its commitments once.

Not in this slice: custom gates, PlonKup lookups, ZK blinding rows and the
mesh-sharded rounds raise NotImplementedError naming the ROADMAP item that
brings them; the batch prover comes with its own slice.

`debug=True` enables the internal invariant checks (gate constraint, Z
closure, quotient degree, T split, R(zeta) = 0, W degrees).
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


def _quotient_impl(
    a, b, c, pi, ql, qr, qm, qo, qc, z, zs, s1, s2, s3, l0, xvals, zh_inv,
    beta, gamma, alpha,
):
    """QUOT on the 4n coset (all inputs coset-extended, [16, 4n])."""
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
):
    """Elementwise round-5 core: (R, W_z, W_zw) values on the 4n coset."""
    S = lambda x: x[:, None]  # noqa: E731
    (a, b, c, _pi, ql, qr, qm, qo, qc, z, _zs, s1, s2, s3, _l0) = bigs

    beta_, gamma_, alpha_, zeta_ = S(beta), S(gamma), S(alpha), S(zeta)
    ab = fr.mul(S(a_ev), S(b_ev))
    gate = fr.add(
        fr.add(fr.add(fr.mul(qm, ab), fr.mul(ql, S(a_ev))), fr.mul(qr, S(b_ev))),
        fr.add(fr.mul(qo, S(c_ev)), fr.add(S(pi_ev), qc)),
    )
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
    r_big = fr.sub(r_core, fr.mul(S(zh_ev), t_combined))

    # W_z = (R + sum v^k (poly - eval)) / (X - zeta)
    acc = r_big
    vp = v
    for poly, ev in ((a, a_ev), (b, b_ev), (c, c_ev), (s1, s1_ev), (s2, s2_ev)):
        acc = fr.add(acc, fr.mul(S(vp), fr.sub(poly, S(ev))))
        vp = fr.mul(vp, v)
    w_z = fr.mul(acc, fr.batch_inv(fr.sub(xvals, S(zeta))))
    w_zw = fr.mul(fr.sub(z, S(zw_ev)), fr.batch_inv(fr.sub(xvals, S(zeta_w))))
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
        if program.has_custom_gates or program.has_lookups:
            raise NotImplementedError(
                "custom gates and PlonKup lookups arrive with the prover "
                "extensions (ROADMAP Queue 1, item 9)"
            )
        if getattr(program, "blinding_rows", 0):
            raise NotImplementedError(
                "ZK blinding rows arrive with the prover extensions "
                "(ROADMAP Queue 1, item 9)"
            )
        if self.config.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded proving arrives with torch.distributed "
                "(ROADMAP Queue 1, item 11)"
            )
        self.group_order = program.group_order
        self.setup = setup
        self.program = program
        self.pk: CommonPreprocessedInput = program.common_preprocessed_input()
        self.debug = self.config.debug_checks
        self.timings = Timings(self.device)
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
        abc = fr.to_mont(to_device(abc_raw, self.device))
        self.A = Polynomial(abc[:, 0, :], Basis.LAGRANGE)
        self.B = Polynomial(abc[:, 1, :], Basis.LAGRANGE)
        self.C = Polynomial(abc[:, 2, :], Basis.LAGRANGE)
        a_1, b_1, c_1 = self._commits(_ntt.ntt(abc, inverse=True), 3)

        if self.debug:
            gate = (
                self.A * self.pk.QL
                + self.B * self.pk.QR
                + self.A * self.B * self.pk.QM
                + self.C * self.pk.QO
                + self.PI
                + self.pk.QC
            )
            assert gate == Polynomial.zeros(n, device=self.device), "gate constraints violated"
        return Message1(a_1, b_1, c_1)

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
        (z_1,) = self._commits(_ntt.ntt(z[:, None, :], inverse=True), 1)
        return Message2(z_1)

    # -- round 3: quotient polynomial ------------------------------------
    def round_3(self) -> Message3:
        n = self.group_order
        off = self.fft_cofactor
        l0 = torch.zeros((NLIMBS, n), dtype=DTYPE, device=self.device)
        l0[:, 0] = fr.const("ONE_MONT", self.device)
        polys = torch.cat(
            [
                torch.stack(
                    [self.A.values, self.B.values, self.C.values, self.PI.values], dim=1
                ),
                self._selector_stack,
                self.Z.values[:, None, :],
                self.Z.shift(1).values[:, None, :],
                torch.stack(self._s_stack, dim=1),
                l0[:, None, :],
            ],
            dim=1,
        )  # [16, 15, n]
        offset = self._s(off)
        bigs = _coset_lift(_ntt.ntt(polys, inverse=True), offset, n)  # [16, 15, 4n]
        qroots, w4p = _coset_x_consts_impl(n, self.device)
        xvals, zh_inv, _zh = _coset_x_impl(offset, self._s(off**n), qroots, w4p)
        quot = _quotient_impl(
            *[bigs[:, i, :] for i in range(15)], xvals, zh_inv,
            self._s(self.beta), self._s(self.gamma), self._s(self.alpha),
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

    # -- round 4: openings -------------------------------------------------
    def round_4(self) -> Message4:
        n = self.group_order
        zeta = self.zeta
        root = Fr.root_of_unity(n)
        values = torch.stack(
            [
                self.A.values, self.B.values, self.C.values,
                self._s_stack[0], self._s_stack[1], self.Z.values,
            ],
            dim=1,
        )
        zl, zwl = self._s(zeta), self._s(zeta * root)
        xs = torch.stack([zl] * 5 + [zwl], dim=1)
        evs = _barycentric_batch(values, xs, n)
        evals = [Fr(v) for v in fr.from_mont_host_many(evs)]
        (
            self.a_eval, self.b_eval, self.c_eval,
            self.s1_eval, self.s2_eval, self.z_shifted_eval,
        ) = evals
        return Message4(*evals)

    # -- round 5: linearization + opening proofs --------------------------
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
