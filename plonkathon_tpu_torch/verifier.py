"""PLONK verifier: the batched single-pairing path and the two-pairing path.

Host arithmetic throughout (a cold path): challenge replay through the
transcript, the linearization algebra, ~20-term MSMs with the host
Pippenger in ec.py, and pairings over the in-repo BN254 implementation.
The verification key optionally carries the cube-gate selector (Qcube) and
the PlonKup commitments (Qk, Tbl) with the table's padding value t_last;
both verifiers then add their terms, as the JAX package's do.
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields import Fr, FQ_MOD, FR_MOD
from .ec import B1, G1, G2, ec_lincomb, ec_mul, is_on_curve, pt_add
from .pairing import pairings_equal
from .transcript import Transcript

# Proof wire format: 9 G1 points + 6 scalars, plus the PlonKup extension's
# 4 points + 8 scalars when lookups are on.
_PROOF_POINTS = (
    "a_1", "b_1", "c_1", "z_1", "t_lo_1", "t_mid_1", "t_hi_1",
    "W_z_1", "W_zw_1",
)
_PROOF_SCALARS = (
    "a_eval", "b_eval", "c_eval", "s1_eval", "s2_eval", "z_shifted_eval",
)
_LOOKUP_POINTS = ("f_1", "h1_1", "h2_1", "z2_1")


def _valid_g1(pt) -> bool:
    """Subgroup membership for a claimed affine G1 point.

    BN254's G1 has prime order with cofactor 1, so on-curve + in-range
    coordinates imply subgroup membership.  The identity is rejected: the
    transcript wire format cannot encode it.  Malformed types are rejected,
    never raised."""
    if pt is None:
        return False
    try:
        x, y = pt
        xi, yi = int(x), int(y)
    except (TypeError, ValueError):
        return False
    if not (0 <= xi < FQ_MOD and 0 <= yi < FQ_MOD):
        return False
    return is_on_curve(pt, B1)


def _valid_fr(s) -> bool:
    try:
        return 0 <= int(s) < FR_MOD
    except (TypeError, ValueError):
        return False


def _halving_keeps(i: int, length: int) -> bool:
    """Whether term i survives the reference's pairwise halving sum over
    `length` terms (`_treesum`, JAX ops/ntt.py), which adds [:half] to
    [half:2 half] at each level and so drops the odd last term of every
    level whose width is odd."""
    while length > 1:
        half = length // 2
        if i >= 2 * half:
            return False
        if i >= half:
            i -= half
        length = half
    return True


def _public_eval(public, group_order: int, zeta: Fr) -> Fr:
    """PI(zeta) exactly as the reference computes it for any length: the
    Lagrange values [-x for x in public], zero-padded to L = max(n,
    len(public)), evaluated barycentrically over L points,
    (zeta^L - 1)/L * sum_i v_i w^i / (zeta - w^i), with w = 5^((r-1)//L)
    (a root of unity only where L divides r - 1; the reference asserts
    nothing) and the terms summed as the reference's halving sums them.
    Zero values add nothing, so only the non-zero entries are walked."""
    length = max(group_order, len(public))
    w = Fr(5) ** ((FR_MOD - 1) // length)
    acc = Fr(0)
    for i, x in enumerate(public):
        v = Fr(-x)
        if v.n != 0 and _halving_keeps(i, length):
            wi = w**i
            acc = acc + v * wi / (zeta - wi)
    return acc * (zeta**length - 1) / length


@dataclass
class VerificationKey:
    """Commitments to the preprocessed circuit."""

    group_order: int
    Qm: tuple  # [q_M(x)]_1
    Ql: tuple  # [q_L(x)]_1
    Qr: tuple  # [q_R(x)]_1
    Qo: tuple  # [q_O(x)]_1
    Qc: tuple  # [q_C(x)]_1
    S1: tuple  # [S_sigma1(x)]_1
    S2: tuple  # [S_sigma2(x)]_1
    S3: tuple  # [S_sigma3(x)]_1
    X_2: tuple  # [x]_2
    w: Fr      # n-th root of unity
    # Cube-gate selector commitment; None for vanilla circuits (the
    # 8-commitment snarkjs layout).
    Qcube: tuple | None = None
    # PlonKup: lookup-selector and table commitments and the table's
    # padding value; None without lookups.
    Qk: tuple | None = None
    Tbl: tuple | None = None
    t_last: Fr | None = None

    # -- challenge replay -------------------------------------------------
    def compute_challenges(self, proof):
        transcript = Transcript(b"plonk")
        beta, gamma = transcript.round_1(proof.msg_1)
        alpha, _fft_cofactor = transcript.round_2(proof.msg_2)
        zeta = transcript.round_3(proof.msg_3)
        v = transcript.round_4(proof.msg_4)
        u = transcript.round_5(proof.msg_5)
        # PlonKup challenges (drawn inside round_1 when the proof has f_1).
        self._delta = getattr(transcript, "delta", None)
        self._epsilon = getattr(transcript, "epsilon", None)
        return beta, gamma, alpha, zeta, v, u

    def _lookup_pieces(self, group_order: int, proof: dict, alpha, zeta):
        """(c_z2, c_h1, c_qk, c_const, e) for PlonKup proofs, None else;
        `e` holds the extra openings keyed as plonkup.EVAL_ORDER."""
        if self.Qk is None:
            return None
        from .plonkup import EVAL_ORDER, linearization_scalars

        e = {k: proof[f"lk_{k}_eval"] for k in EVAL_ORDER}
        e["a"] = proof["a_eval"]
        return (
            *linearization_scalars(
                group_order, alpha, zeta, self._delta, self._epsilon, e,
                self.t_last, self.w,
            ),
            e,
        )

    def _validate_proof(self, proof: dict) -> bool:
        """Structural well-formedness, checked BEFORE any pairing."""
        points = _PROOF_POINTS + (_LOOKUP_POINTS if self.Qk is not None else ())
        for key in points:
            if key not in proof or not _valid_g1(proof[key]):
                return False
        scalar_keys = list(_PROOF_SCALARS)
        if self.Qk is not None:
            from .plonkup import EVAL_ORDER

            scalar_keys += [f"lk_{k}_eval" for k in EVAL_ORDER]
        for key in scalar_keys:
            if key not in proof or not _valid_fr(proof[key]):
                return False
        return True

    def _common_evals(self, group_order: int, zeta: Fr, public):
        zh_ev = zeta**group_order - 1
        l0_ev = zh_ev / (group_order * (zeta - 1))
        pi_ev = _public_eval(public, group_order, zeta)
        return zh_ev, l0_ev, pi_ev

    def _cube_term(self, a_ev) -> list:
        """[(Qcube, a_eval^3)] for cube-gate keys, [] else."""
        return [(self.Qcube, a_ev**3)] if self.Qcube is not None else []

    # -- optimized: one combined pairing check ----------------------------
    def verify_proof(self, group_order: int, pf, public=()) -> bool:
        proof = pf.flatten()
        if not self._validate_proof(proof):
            return False  # malformed proof (off-curve point / bad scalar)
        beta, gamma, alpha, zeta, v, u = self.compute_challenges(pf)
        zh_ev, l0_ev, pi_ev = self._common_evals(group_order, zeta, public)
        lk = self._lookup_pieces(group_order, proof, alpha, zeta)

        a_ev, b_ev, c_ev = proof["a_eval"], proof["b_eval"], proof["c_eval"]
        s1_ev, s2_ev = proof["s1_eval"], proof["s2_eval"]
        zw_ev = proof["z_shifted_eval"]

        # Constant part of the linearization polynomial.
        r0 = (
            pi_ev
            - l0_ev * alpha**2
            - alpha
            * (a_ev + beta * s1_ev + gamma)
            * (b_ev + beta * s2_ev + gamma)
            * (c_ev + gamma)
            * zw_ev
        )
        lk_terms, lk_open_z, lk_open_zw = [], [], []
        ev_z = ev_zw = Fr(0)
        if lk is not None:
            c_z2, c_h1, c_qk, c_const, e = lk
            r0 = r0 + c_const
            lk_terms = [
                (proof["z2_1"], c_z2),
                (proof["h1_1"], c_h1),
                (self.Qk, c_qk),
            ]
            # W_z batches (f, t, h1, h2) at v^6..v^9; W_zw is the RLC of
            # (z, t, h1, h2, z2) at v^0..v^4 (weight u overall).
            lk_open_z = [
                (proof["f_1"], v**6), (self.Tbl, v**7),
                (proof["h1_1"], v**8), (proof["h2_1"], v**9),
            ]
            ev_z = v**6 * e["f"] + v**7 * e["t"] + v**8 * e["h1"] + v**9 * e["h2"]
            lk_open_zw = [
                (self.Tbl, u * v), (proof["h1_1"], u * v**2),
                (proof["h2_1"], u * v**3), (proof["z2_1"], u * v**4),
            ]
            ev_zw = (
                v * e["t_w"] + v**2 * e["h1_w"] + v**3 * e["h2_w"]
                + v**4 * e["z2_w"]
            )

        # D = [R]_1 - r0*G + u*[z]_1
        d_pt = ec_lincomb(
            self._cube_term(a_ev)
            + lk_terms
            + [
                (self.Qm, a_ev * b_ev),
                (self.Ql, a_ev),
                (self.Qr, b_ev),
                (self.Qo, c_ev),
                (self.Qc, 1),
                (
                    proof["z_1"],
                    (a_ev + beta * zeta + gamma)
                    * (b_ev + beta * 2 * zeta + gamma)
                    * (c_ev + beta * 3 * zeta + gamma)
                    * alpha
                    + l0_ev * alpha**2
                    + u,
                ),
                (
                    self.S3,
                    -(a_ev + beta * s1_ev + gamma)
                    * (b_ev + beta * s2_ev + gamma)
                    * alpha
                    * beta
                    * zw_ev,
                ),
                (proof["t_lo_1"], -zh_ev),
                (proof["t_mid_1"], -zh_ev * zeta**group_order),
                (proof["t_hi_1"], -zh_ev * zeta ** (group_order * 2)),
            ]
        )

        f_pt = ec_lincomb(
            [
                (d_pt, 1),
                (proof["a_1"], v),
                (proof["b_1"], v**2),
                (proof["c_1"], v**3),
                (self.S1, v**4),
                (self.S2, v**5),
            ]
            + lk_open_z
            + lk_open_zw
        )
        e_pt = ec_mul(
            G1,
            -r0
            + v * a_ev
            + v**2 * b_ev
            + v**3 * c_ev
            + v**4 * s1_ev
            + v**5 * s2_ev
            + u * zw_ev
            + ev_z
            + u * ev_zw,
        )

        # Combined KZG opening check at zeta and zeta*omega with one random
        # linear combination (weight u): e([W_z + u W_zw], [x]_2) ==
        # e([zeta W_z + u zeta w W_zw + F - E], [1]_2).
        return pairings_equal(
            self.X_2, ec_lincomb([(proof["W_z_1"], 1), (proof["W_zw_1"], u)]),
            G2,
            ec_lincomb(
                [
                    (proof["W_z_1"], zeta),
                    (proof["W_zw_1"], u * zeta * self.w),
                    (f_pt, 1),
                    (e_pt, -1),
                ]
            ),
        )

    # -- unoptimized: explicit R reconstruction, two pairing checks -------
    def verify_proof_unoptimized(self, group_order: int, pf, public=()) -> bool:
        proof = pf.flatten()
        if not self._validate_proof(proof):
            return False  # malformed proof (off-curve point / bad scalar)
        beta, gamma, alpha, zeta, v, _u = self.compute_challenges(pf)
        zh_ev, l0_ev, pi_ev = self._common_evals(group_order, zeta, public)
        lk = self._lookup_pieces(group_order, proof, alpha, zeta)
        lk_terms, lk_open_z = [], []
        if lk is not None:
            c_z2, c_h1, c_qk, c_const, e = lk
            lk_terms = [
                (proof["z2_1"], c_z2),
                (proof["h1_1"], c_h1),
                (self.Qk, c_qk),
                (G1, c_const),
            ]
            lk_open_z = [
                (proof["f_1"], v**6), (G1, -(v**6) * e["f"]),
                (self.Tbl, v**7), (G1, -(v**7) * e["t"]),
                (proof["h1_1"], v**8), (G1, -(v**8) * e["h1"]),
                (proof["h2_1"], v**9), (G1, -(v**9) * e["h2"]),
            ]

        a_ev, b_ev, c_ev = proof["a_eval"], proof["b_eval"], proof["c_eval"]
        s1_ev, s2_ev = proof["s1_eval"], proof["s2_eval"]
        zw_ev = proof["z_shifted_eval"]

        # Reconstruct [R]_1 exactly as the prover linearized it.
        r_pt = ec_lincomb(
            self._cube_term(a_ev)
            + lk_terms
            + [
                (self.Qm, a_ev * b_ev),
                (self.Ql, a_ev),
                (self.Qr, b_ev),
                (self.Qo, c_ev),
                (G1, pi_ev),
                (self.Qc, 1),
                (
                    proof["z_1"],
                    (a_ev + beta * zeta + gamma)
                    * (b_ev + beta * 2 * zeta + gamma)
                    * (c_ev + beta * 3 * zeta + gamma)
                    * alpha,
                ),
                (
                    self.S3,
                    -(a_ev + beta * s1_ev + gamma)
                    * (b_ev + beta * s2_ev + gamma)
                    * beta
                    * alpha
                    * zw_ev,
                ),
                (
                    G1,
                    -(a_ev + beta * s1_ev + gamma)
                    * (b_ev + beta * s2_ev + gamma)
                    * (c_ev + gamma)
                    * alpha
                    * zw_ev,
                ),
                (proof["z_1"], l0_ev * alpha**2),
                (G1, -l0_ev * alpha**2),
                (proof["t_lo_1"], -zh_ev),
                (proof["t_mid_1"], -zh_ev * zeta**group_order),
                (proof["t_hi_1"], -zh_ev * zeta ** (group_order * 2)),
            ]
        )

        # Check 1: R(zeta) = 0 and the openings of A, B, C, S1, S2 (and, with
        # lookups, f, t, h1, h2) at zeta.
        agg = ec_lincomb(
            [
                (r_pt, 1),
                (proof["a_1"], v),
                (G1, -v * a_ev),
                (proof["b_1"], v**2),
                (G1, -(v**2) * b_ev),
                (proof["c_1"], v**3),
                (G1, -(v**3) * c_ev),
                (self.S1, v**4),
                (G1, -(v**4) * s1_ev),
                (self.S2, v**5),
                (G1, -(v**5) * s2_ev),
            ]
            + lk_open_z
        )
        if not pairings_equal(
            G2, agg, pt_add(self.X_2, ec_mul(G2, -zeta)), proof["W_z_1"]
        ):
            return False  # opening check at zeta failed

        # Check 2: the opening of Z (and, with lookups, the v-RLC with t,
        # h1, h2, Z2) at zeta*omega.
        zw_terms = [(proof["z_1"], Fr(1)), (G1, -zw_ev)]
        if lk is not None:
            e = lk[4]
            zw_terms += [
                (self.Tbl, v), (G1, -v * e["t_w"]),
                (proof["h1_1"], v**2), (G1, -(v**2) * e["h1_w"]),
                (proof["h2_1"], v**3), (G1, -(v**3) * e["h2_w"]),
                (proof["z2_1"], v**4), (G1, -(v**4) * e["z2_w"]),
            ]
        if not pairings_equal(
            G2, ec_lincomb(zw_terms), pt_add(self.X_2, ec_mul(G2, -zeta * self.w)),
            proof["W_zw_1"],
        ):
            return False  # opening check at zeta*omega failed
        return True
