"""PlonKup: lookup gates integrated into the main PLONK prover/verifier.

Reference README.md:29-37 lists "add support for lookups (PlonKup)" as an
extension; the reference implements none.  This module holds the protocol
math shared between prover.py and verifier.py for the INTEGRATED variant
(`x lookup` rows in the circuit DSL + `Program(lookup_table=...)`); the
standalone single-table plookup protocol lives in lookup.py.

Protocol (single-column PlonKup; plookup multiset argument of
Gabizon-Williamson woven into the 5-round PLONK schedule):

* Preprocessed: q_K (1 on lookup rows), TBL (public table padded to n with
  its last entry t_last, which doubles as the dummy query).
* Round 1 additionally commits the query polynomial
      f_i = q_K(i) * a_i + (1 - q_K(i)) * t_last         (rows 0..n-1)
  and the sorted-concatenation halves h1, h2 of s = sort_t(f[0..n-2] ++ t)
  (challenge-free in the single-column case).  The transcript then yields
  beta/gamma (permutation) AND delta/epsilon (lookup).
* Round 2 additionally commits the lookup grand product Z2 (plookup
  recurrence over rows 0..n-2 with delta/epsilon).
* Round 3 folds five extra identities into the SAME quotient, weighted by
  alpha^3..alpha^7 (vanilla PLONK uses alpha^0..alpha^2):
    (a') L_0 * (Z2 - 1)
    (b') (x - w^{n-1}) * [ Z2*(1+d)*(e+f)*(e(1+d) + t + d*t(wx))
                           - Z2(wx)*(e(1+d) + h1 + d*h1(wx))
                                   *(e(1+d) + h2 + d*h2(wx)) ]
    (c') L_{n-1} * (h1 - h2(wx))
    (d') L_{n-1} * (Z2 - 1)
    (e') q_K*(a - f) + (1 - q_K)*(t_last - f)      [f well-formedness]
  The b'-term has degree 3n-2, so the quotient still splits into the three
  degree-<n chunks T1/T2/T3.
* Round 4 additionally opens f, t, h1, h2 at zeta and t, h1, h2, Z2 at
  zeta*omega (q_K and Z2(zeta) are linearized away, like S3 and Z in
  vanilla PLONK).
* Round 5: R gains the three linearized commitment terms + a constant
  (`linearization_scalars` below); W_z batches f, t, h1, h2 at v^6..v^9;
  W_zw becomes the RLC (z, t, h1, h2, Z2) at powers v^0..v^4.

Zero-knowledge: with blinding_rows > 0 the prover blinds f (2 Z_H-multiple
blinders), h1 / h2 / Z2 (3 each — opened at zeta and zeta*omega) alongside
the vanilla Z blinding.  The quotient degree stays < 3n (the dominant
blinded b'-term is (x - w^{n-1}) * Z2' * (h1-term) * (h2-term), degree
3n + 7 before the Z_H division), so the T1/T2/T3 split and the n+3-wide
opening quotients are unchanged.
"""

from __future__ import annotations

from .fields import Fr

# Transcript absorption order of the eight extra round-4 evaluations.
EVAL_ORDER = ("f", "t", "h1", "h2", "t_w", "h1_w", "h2_w", "z2_w")


def sorted_by_table(fvals: list[int], tvals: list[int]) -> list[int]:
    """Concatenation of f and t, sorted by t's order (plookup's `s`).

    Every f value must appear in t; len(result) == len(f) + len(t)."""
    from collections import Counter

    extra = Counter(fvals)
    s = []
    seen = set()
    for v in tvals:
        s.append(v)
        if v not in seen:
            seen.add(v)
            s.extend([v] * extra.get(v, 0))
    return s


def linearization_scalars(
    n: int, alpha: Fr, zeta: Fr, delta: Fr, epsilon: Fr,
    evals: dict, t_last: Fr, root: Fr,
):
    """Host-side Fr scalars of the lookup linearization at zeta.

    `evals`: {"a", "f", "t", "h1", "h2", "t_w", "h1_w", "h2_w", "z2_w"}.
    Returns (c_z2, c_h1, c_qk, c_const) such that the lookup contribution
    to the linearization polynomial R is

        c_z2 * Z2(X) + c_h1 * h1(X) + c_qk * q_K(X) + c_const.

    Both the prover (R construction, round 5) and the verifier (D/E point
    coefficients) call this — a single source of truth for the algebra.
    """
    zh_ev = zeta**n - 1
    gl = root ** (n - 1)
    l0_ev = zh_ev / (n * (zeta - 1))
    ln_ev = (zh_ev * gl) / (n * (zeta - gl))
    xm = zeta - gl
    od = Fr(1) + delta
    ed = epsilon * od
    a3 = alpha**3
    a4 = a3 * alpha
    a5 = a4 * alpha
    a6 = a5 * alpha
    a7 = a6 * alpha
    e = {k: Fr(v) for k, v in evals.items()}
    c_z2 = (
        a3 * l0_ev
        + a4 * xm * od * (epsilon + e["f"]) * (ed + e["t"] + delta * e["t_w"])
        + a6 * ln_ev
    )
    c_h1 = a5 * ln_ev
    c_qk = a7 * ((e["a"] - e["f"]) - (t_last - e["f"]))
    c_const = (
        -a3 * l0_ev
        - a4 * xm * e["z2_w"]
        * (ed + e["h1"] + delta * e["h1_w"])
        * (ed + e["h2"] + delta * e["h2_w"])
        - a5 * ln_ev * e["h2_w"]
        - a6 * ln_ev
        + a7 * (t_last - e["f"])
    )
    return c_z2, c_h1, c_qk, c_const
