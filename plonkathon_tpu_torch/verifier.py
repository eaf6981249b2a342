"""PLONK verifier: the batched single-pairing path and the two-pairing path.

Host arithmetic throughout (a cold path): challenge replay through the
transcript, the linearization algebra, ~20-term MSMs with the host
Pippenger in ec.py, and pairings over the in-repo BN254 implementation.
Vanilla PLONK layout: the custom-gate and PlonKup extensions of the JAX
package's verifier arrive with the prover extensions (ROADMAP Queue 1,
item 9).
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields import Fr, FQ_MOD, FR_MOD
from .ec import B1, G1, G2, ec_lincomb, ec_mul, is_on_curve, pt_add
from .pairing import pairing
from .transcript import Transcript

# Proof wire format: 9 G1 points + 6 scalars.
_PROOF_POINTS = (
    "a_1", "b_1", "c_1", "z_1", "t_lo_1", "t_mid_1", "t_hi_1",
    "W_z_1", "W_zw_1",
)
_PROOF_SCALARS = (
    "a_eval", "b_eval", "c_eval", "s1_eval", "s2_eval", "z_shifted_eval",
)


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


def _lagrange_eval(values, group_order: int, zeta: Fr) -> Fr:
    """Barycentric evaluation at zeta of Lagrange values given sparsely
    (the public inputs): (zeta^n - 1)/n * sum_i v_i w^i / (zeta - w^i)."""
    w = Fr.root_of_unity(group_order)
    acc = Fr(0)
    wi = Fr(1)
    for v in values:
        if int(v) != 0:
            acc = acc + Fr(v) * wi / (zeta - wi)
        wi = wi * w
    return acc * (zeta**group_order - 1) / group_order


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

    # -- challenge replay -------------------------------------------------
    def compute_challenges(self, proof):
        transcript = Transcript(b"plonk")
        beta, gamma = transcript.round_1(proof.msg_1)
        alpha, _fft_cofactor = transcript.round_2(proof.msg_2)
        zeta = transcript.round_3(proof.msg_3)
        v = transcript.round_4(proof.msg_4)
        u = transcript.round_5(proof.msg_5)
        return beta, gamma, alpha, zeta, v, u

    def _validate_proof(self, proof: dict) -> bool:
        """Structural well-formedness, checked BEFORE any pairing."""
        for key in _PROOF_POINTS:
            if key not in proof or not _valid_g1(proof[key]):
                return False
        for key in _PROOF_SCALARS:
            if key not in proof or not _valid_fr(proof[key]):
                return False
        return True

    def _common_evals(self, group_order: int, zeta: Fr, public):
        zh_ev = zeta**group_order - 1
        l0_ev = zh_ev / (group_order * (zeta - 1))
        pi_ev = _lagrange_eval([Fr(-x) for x in public], group_order, zeta)
        return zh_ev, l0_ev, pi_ev

    # -- optimized: one combined pairing check ----------------------------
    def verify_proof(self, group_order: int, pf, public=()) -> bool:
        proof = pf.flatten()
        if not self._validate_proof(proof):
            return False  # malformed proof (off-curve point / bad scalar)
        beta, gamma, alpha, zeta, v, u = self.compute_challenges(pf)
        zh_ev, l0_ev, pi_ev = self._common_evals(group_order, zeta, public)

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

        # D = [R]_1 - r0*G + u*[z]_1
        d_pt = ec_lincomb(
            [
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
        )
        e_pt = ec_mul(
            G1,
            -r0
            + v * a_ev
            + v**2 * b_ev
            + v**3 * c_ev
            + v**4 * s1_ev
            + v**5 * s2_ev
            + u * zw_ev,
        )

        # Combined KZG opening check at zeta and zeta*omega with one random
        # linear combination (weight u): e([W_z + u W_zw], [x]_2) ==
        # e([zeta W_z + u zeta w W_zw + F - E], [1]_2).
        lhs = pairing(
            self.X_2, ec_lincomb([(proof["W_z_1"], 1), (proof["W_zw_1"], u)])
        )
        rhs = pairing(
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
        return lhs == rhs

    # -- unoptimized: explicit R reconstruction, two pairing checks -------
    def verify_proof_unoptimized(self, group_order: int, pf, public=()) -> bool:
        proof = pf.flatten()
        if not self._validate_proof(proof):
            return False  # malformed proof (off-curve point / bad scalar)
        beta, gamma, alpha, zeta, v, _u = self.compute_challenges(pf)
        zh_ev, l0_ev, pi_ev = self._common_evals(group_order, zeta, public)

        a_ev, b_ev, c_ev = proof["a_eval"], proof["b_eval"], proof["c_eval"]
        s1_ev, s2_ev = proof["s1_eval"], proof["s2_eval"]
        zw_ev = proof["z_shifted_eval"]

        # Reconstruct [R]_1 exactly as the prover linearized it.
        r_pt = ec_lincomb(
            [
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

        # Check 1: R(zeta) = 0 and the openings of A, B, C, S1, S2 at zeta.
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
        )
        if pairing(G2, agg) != pairing(
            pt_add(self.X_2, ec_mul(G2, -zeta)), proof["W_z_1"]
        ):
            return False  # opening check at zeta failed

        # Check 2: the opening of Z at zeta*omega.
        zw_terms = [(proof["z_1"], Fr(1)), (G1, -zw_ev)]
        if pairing(G2, ec_lincomb(zw_terms)) != pairing(
            pt_add(self.X_2, ec_mul(G2, -zeta * self.w)), proof["W_zw_1"]
        ):
            return False  # opening check at zeta*omega failed
        return True
