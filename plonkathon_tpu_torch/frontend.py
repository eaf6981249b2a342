"""Circuit frontend: the zkrepl-style constraint DSL and PLONK preprocessing.

Host-side compiler (circuits are compiled once; proving is the hot path).
Produces selector and permutation polynomials on the program's device
(CUDA unless the caller asks for the CPU), consumed by the prover.

Language semantics — equation forms `out <== expr`, `out === expr`,
`var public`; {+,-,*} with multiplicative degree <= 2 and at most two distinct
variables per constraint — match the reference compiler exactly
(compiler/assembly.py:122-166, compiler/program.py:33-192), including the
permutation-cycle encoding with column labels omega^row * {1,2,3}, pinned by
the snarkjs golden vkey fixtures (k1=2, k2=3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .fields import Fr, FR_MOD
from .ops.limbs import resolve_device
from .poly import Polynomial, Basis

# Wire columns; the integer value doubles as the permutation coset tag
# (k1 = 2, k2 = 3 in the snarkjs vkeys).
COL_LEFT, COL_RIGHT, COL_OUTPUT = 1, 2, 3
_COLUMNS = (COL_LEFT, COL_RIGHT, COL_OUTPUT)


def product_key(a: Optional[str], b: Optional[str]) -> str:
    """Canonical dict key for the product term a*b."""
    parts = sorted((a or "").split("*") + (b or "").split("*"))
    return "*".join(x for x in parts if x)


def is_valid_variable_name(name: str) -> bool:
    return len(name) > 0 and name.isalnum() and name[0] not in "0123456789"


def _combine_linear(lhs: dict, rhs: dict) -> dict:
    keys = set(lhs) | set(rhs)
    return {k: lhs.get(k, 0) + rhs.get(k, 0) for k in keys}


def parse_expression(tokens: list[str], negate_first: bool = False) -> dict:
    """Token list over {+,-,*} -> {term: coefficient} map.

    Splits on +/- before * (order of operations); `negate_first` tracks sign
    propagation through chained subtractions, e.g. 6000 - 700 - 80 + 9.
    """
    if "+" in tokens:
        cut = tokens.index("+")
        return _combine_linear(
            parse_expression(tokens[:cut], negate_first),
            parse_expression(tokens[cut + 1 :], False),
        )
    if "-" in tokens:
        cut = tokens.index("-")
        return _combine_linear(
            parse_expression(tokens[:cut], negate_first),
            parse_expression(tokens[cut + 1 :], True),
        )
    if "*" in tokens:
        cut = tokens.index("*")
        lhs = parse_expression(tokens[:cut], negate_first)
        rhs = parse_expression(tokens[cut + 1 :], negate_first)
        return {
            product_key(kl, kr): cl * cr
            for kl, cl in lhs.items()
            for kr, cr in rhs.items()
        }
    if len(tokens) != 1:
        raise ValueError(f"expected a single unit, got: {tokens}")
    tok = tokens[0]
    if tok.startswith("-"):
        return parse_expression([tok[1:]], not negate_first)
    if tok.isnumeric():
        return {"": int(tok) * (-1 if negate_first else 1)}
    if is_valid_variable_name(tok):
        return {tok: -1 if negate_first else 1}
    raise ValueError(f"unparseable token: {tok!r}")


@dataclass
class Wires:
    """Variable names on the Left/Right/Output wires of one gate row."""

    L: Optional[str]
    R: Optional[str]
    O: Optional[str]

    def as_list(self) -> list[Optional[str]]:
        return [self.L, self.R, self.O]


@dataclass
class Constraint:
    """One compiled gate row: wire names + {term: coefficient} map."""

    wires: Wires
    coeffs: dict

    def selectors(self) -> tuple[Fr, Fr, Fr, Fr, Fr]:
        """(qL, qR, qM, qO, qC) for this row."""
        w, c = self.wires, self.coeffs
        if c.get("$cube"):
            # Custom cube row: the whole equation is q_cube*(A^3) + qO*C = 0
            # with q_cube = -1 (see `qcube`); vanilla selectors stay zero.
            return Fr(0), Fr(0), Fr(0), Fr(c.get("$output_coeff", 1)), Fr(0)
        ql = Fr(-c.get(w.L, 0))
        qr = Fr(-c.get(w.R, 0)) if w.R != w.L else Fr(0)
        qm = (
            Fr(-c.get(product_key(w.L, w.R), 0))
            if None not in self.wires.as_list()
            else Fr(0)
        )
        qo = Fr(c.get("$output_coeff", 1))
        qc = Fr(-c.get("", 0))
        return ql, qr, qm, qo, qc

    def qcube(self) -> Fr:
        """Custom-gate selector (TurboPlonK extension, README.md:29-31 of
        the reference's extension track): -1 on cube rows, 0 elsewhere.
        Row equation gains q_cube * A^3, so -A^3 + C = 0 <=> C = A^3."""
        return Fr(-1) if self.coeffs.get("$cube") else Fr(0)


def parse_constraint(line: str, custom_gates: bool = False) -> Constraint:
    """One source line -> Constraint (reference compiler/assembly.py:122-166).

    With `custom_gates=True`, `out <== x * x * x` compiles to ONE custom
    cube-gate row (the vanilla grammar rejects degree-3 terms; without the
    flag it takes three rows: x2 = x*x, x3 = x2*x)."""
    tokens = line.rstrip("\n").split(" ")
    if (
        custom_gates
        and len(tokens) == 7
        and tokens[1] == "<=="
        and tokens[3] == tokens[5] == "*"
        and tokens[2] == tokens[4] == tokens[6]
        and is_valid_variable_name(tokens[0])
        and is_valid_variable_name(tokens[2])
    ):
        return Constraint(
            Wires(tokens[2], tokens[2], tokens[0]),
            {"$cube": True, "$output_coeff": 1},
        )
    if len(tokens) > 1 and tokens[1] in ("<==", "==="):
        out = tokens[0]
        coeffs = parse_expression(tokens[2:])
        if out.startswith("-"):
            out = out[1:]
            coeffs["$output_coeff"] = -1
        if not is_valid_variable_name(out):
            raise ValueError(f"invalid output variable: {out}")
        variables: list[str] = []
        for t in tokens[2:]:
            name = t.lstrip("-")
            if is_valid_variable_name(name) and name not in variables:
                variables.append(name)
        allowed = set(variables) | {"", "$output_coeff"}
        if len(variables) == 1:
            variables.append(variables[0])
            allowed.add(product_key(variables[0], variables[0]))
        elif len(variables) == 2:
            allowed.add(product_key(*variables))
        elif len(variables) > 2:
            raise ValueError(f"at most 2 variables per constraint, got {variables}")
        for key in coeffs:
            if key not in allowed:
                raise ValueError(f"disallowed term: {key}")
        padded = variables + [None] * (2 - len(variables))
        return Constraint(Wires(padded[0], padded[1], out), coeffs)
    if len(tokens) > 1 and tokens[1] == "public":
        return Constraint(
            Wires(tokens[0], None, None),
            {tokens[0]: -1, "$output_coeff": 0, "$public": True},
        )
    if len(tokens) == 2 and tokens[1] == "lookup":
        # PlonKup lookup row (reference extension track, README.md:29-37):
        # `x lookup` asserts the value of x lies in the program's lookup
        # table.  The row carries NO gate constraint (all selectors zero);
        # x occupies the A column, so the copy-constraint cycles tie it to
        # x's other uses, and the lookup selector q_K is 1 on this row.
        if not is_valid_variable_name(tokens[0]):
            raise ValueError(f"invalid lookup variable: {tokens[0]}")
        return Constraint(
            Wires(tokens[0], None, None),
            {"$lookup": True, "$output_coeff": 0},
        )
    raise ValueError(f"unsupported statement: {line!r}")


@dataclass
class CommonPreprocessedInput:
    """Selector + permutation polynomials (reference compiler/program.py:10-30).

    QCUBE is the optional custom-gate selector (TurboPlonK extension);
    None for vanilla circuits, keeping the 8-commitment VK layout and
    snarkjs vkey compatibility untouched."""

    group_order: int
    QM: Polynomial
    QL: Polynomial
    QR: Polynomial
    QO: Polynomial
    QC: Polynomial
    S1: Polynomial
    S2: Polynomial
    S3: Polynomial
    QCUBE: Optional[Polynomial] = None
    # PlonKup lookup extension: selector (1 on lookup rows), the table
    # polynomial (public table padded to n with its last value), and that
    # padding value itself (the "dummy" query of non-lookup rows).
    QK: Optional[Polynomial] = None
    TBL: Optional[Polynomial] = None
    t_last: Optional[Fr] = None


class Program:
    """A compiled constraint system over a power-of-two evaluation domain."""

    def __init__(
        self, constraints: list[str], group_order: int,
        custom_gates: bool = False, blinding_rows: int = 0,
        lookup_table: Optional[list[int]] = None,
        device="cuda",
    ):
        """`device`: where the preprocessed polynomials live ("cuda" unless
        the caller asks for "cpu"; raises when CUDA is asked for and absent).

        `blinding_rows=t` reserves the LAST t rows for zero-knowledge
        blinding (Halo2-style): those rows carry no constraints, their
        permutation cells are singleton cycles (identity sigma), and the
        prover fills their wire values with fresh randomness per proof.
        Statistical hiding grows with t; t >= 3 covers the three wire-poly
        openings of one proof.  t = 0 (default) keeps proofs deterministic
        and bit-identical to the reference."""
        self.device = resolve_device(device)
        if len(constraints) > group_order - blinding_rows:
            raise ValueError("group order too small for constraint count")
        self.group_order = group_order
        self.custom_gates = custom_gates
        self.blinding_rows = blinding_rows
        self.constraints = [
            parse_constraint(line, custom_gates) for line in constraints
        ]
        self.lookup_table = (
            None if lookup_table is None else [x % FR_MOD for x in lookup_table]
        )
        self._preprocessed = None
        if self.has_lookups:
            if self.lookup_table is None:
                raise ValueError("lookup rows require a lookup_table")
            # blinding_rows > 0 composes with lookups: the wires blind via
            # the reserved random rows (where q_K = 0, so f = t_last and the
            # lookup identities hold), and the prover blinds f / h1 / h2 /
            # Z2 with Z_H-multiples (prover.py round_1/round_2).
        if self.lookup_table is not None:
            if not self.lookup_table:
                raise ValueError("lookup_table must be non-empty")
            if len(self.lookup_table) > group_order:
                raise ValueError("lookup_table larger than the group order")
            # The multiset argument runs over rows 0..n-2 (the last domain
            # element closes the grand product), so row n-1 cannot host a
            # lookup query.
            for i, c in enumerate(self.constraints):
                if c.coeffs.get("$lookup") and i == group_order - 1:
                    raise ValueError("lookup row cannot occupy the last row")

    @property
    def has_custom_gates(self) -> bool:
        return any(c.coeffs.get("$cube") for c in self.constraints)

    @property
    def has_lookups(self) -> bool:
        return any(c.coeffs.get("$lookup") for c in self.constraints)

    @classmethod
    def from_str(
        cls, source: str, group_order: int, custom_gates: bool = False,
        lookup_table: Optional[list[int]] = None, device="cuda",
    ) -> "Program":
        return cls(
            [line.strip() for line in source.split("\n")], group_order,
            custom_gates, lookup_table=lookup_table, device=device,
        )

    def wires(self) -> list[Wires]:
        return [c.wires for c in self.constraints]

    def coeffs(self) -> list[dict]:
        return [c.coeffs for c in self.constraints]

    # -- public inputs ----------------------------------------------------
    def get_public_assignments(self) -> list[Optional[str]]:
        """Ordered public variable names; declarations must lead the program
        (reference compiler/program.py:116-130)."""
        out = []
        closed = False
        for c in self.constraints:
            if c.coeffs.get("$public", False) is True:
                if closed:
                    raise ValueError("public declarations must come first")
                names = [k for k in c.coeffs if "$" not in str(k)]
                var = names[0]
                if c.coeffs != {"$public": True, "$output_coeff": 0, var: -1}:
                    raise ValueError(f"malformed public declaration: {c.coeffs}")
                out.append(var)
            else:
                closed = True
        return out

    # -- preprocessing ----------------------------------------------------
    def make_gate_polynomials(self):
        """(QL, QR, QM, QO, QC) Lagrange polys (reference compiler/program.py:134-155)."""
        n = self.group_order
        rows = {name: [Fr(0)] * n for name in "LRMOC"}
        for i, c in enumerate(self.constraints):
            ql, qr, qm, qo, qc = c.selectors()
            rows["L"][i], rows["R"][i], rows["M"][i] = ql, qr, qm
            rows["O"][i], rows["C"][i] = qo, qc
        return tuple(
            Polynomial(rows[name], Basis.LAGRANGE, self.device) for name in "LRMOC"
        )

    def make_s_polynomials(self):
        """Permutation polynomials S1, S2, S3 via copy-constraint cycles.

        Each variable's use sites ((row, column) cells, ordered) are rotated
        by one; a cell is encoded as omega^row * column_tag.  Unused cells
        beyond the constraint list join the `None` cycle.  (Reference
        compiler/program.py:70-113.)
        """
        n = self.group_order
        uses: dict[Optional[str], set] = {None: set()}
        for row, c in enumerate(self.constraints):
            for col, name in zip(_COLUMNS, c.wires.as_list()):
                uses.setdefault(name, set()).add((row, col))
        for row in range(len(self.constraints), n - self.blinding_rows):
            for col in _COLUMNS:
                uses[None].add((row, col))
        # Blinding rows: every cell is its OWN singleton cycle (sigma =
        # identity), so the permutation argument places no copy constraint
        # on them and the prover may fill them with per-proof randomness.
        # (Joining the None cycle would force them all equal.)
        for row in range(n - self.blinding_rows, n):
            for col in _COLUMNS:
                uses[f"$blind{row}_{col}"] = {(row, col)}

        roots = Fr.roots_of_unity(n)
        s_vals = {col: [Fr(0)] * n for col in _COLUMNS}
        for sites in uses.values():
            ordered = sorted(sites)
            for i, (row, col) in enumerate(ordered):
                next_row, next_col = ordered[(i + 1) % len(ordered)]
                s_vals[next_col][next_row] = roots[row] * col
        return (
            Polynomial(s_vals[COL_LEFT], Basis.LAGRANGE, self.device),
            Polynomial(s_vals[COL_RIGHT], Basis.LAGRANGE, self.device),
            Polynomial(s_vals[COL_OUTPUT], Basis.LAGRANGE, self.device),
        )

    def make_qcube_polynomial(self) -> Optional[Polynomial]:
        """Custom cube-gate selector, or None if the circuit has none."""
        if not self.has_custom_gates:
            return None
        vals = [Fr(0)] * self.group_order
        for i, c in enumerate(self.constraints):
            vals[i] = c.qcube()
        return Polynomial(vals, Basis.LAGRANGE, self.device)

    def make_lookup_polynomials(self):
        """(QK, TBL, t_last) for PlonKup circuits, (None, None, None) else.

        QK is 1 exactly on lookup rows; TBL is the public table padded to
        the group order by repeating its last entry (that entry doubles as
        the dummy query value of non-lookup rows)."""
        if not self.has_lookups:
            return None, None, None
        n = self.group_order
        qk = [Fr(0)] * n
        for i, c in enumerate(self.constraints):
            if c.coeffs.get("$lookup"):
                qk[i] = Fr(1)
        tbl = [Fr(v) for v in self.lookup_table]
        tbl += [tbl[-1]] * (n - len(tbl))
        return (
            Polynomial(qk, Basis.LAGRANGE, self.device),
            Polynomial(tbl, Basis.LAGRANGE, self.device),
            tbl[-1],
        )

    def common_preprocessed_input(self) -> CommonPreprocessedInput:
        """The circuit's selectors, permutation and lookup columns, built at
        the first call and kept: a Program does not change once built, and
        every Prover, BatchProver and verification key of it asks for them
        (seconds of host work at n = 2^18)."""
        if self._preprocessed is None:
            ql, qr, qm, qo, qc = self.make_gate_polynomials()
            s1, s2, s3 = self.make_s_polynomials()
            qk, tbl, t_last = self.make_lookup_polynomials()
            self._preprocessed = CommonPreprocessedInput(
                self.group_order, qm, ql, qr, qo, qc, s1, s2, s3,
                QCUBE=self.make_qcube_polynomial(),
                QK=qk, TBL=tbl, t_last=t_last,
            )
        return self._preprocessed

    # -- witness generation ----------------------------------------------
    def fill_variable_assignments(self, starting: dict) -> dict:
        """Forward-execute rows to complete the witness; raises on
        contradictions (reference compiler/program.py:161-192)."""
        out = {k: Fr(v) for k, v in starting.items()}
        out[None] = Fr(0)
        for c in self.constraints:
            w, coeffs = c.wires, c.coeffs
            out_coeff = coeffs.get("$output_coeff", 1)
            if w.O is None or out_coeff not in (-1, 1):
                continue
            if coeffs.get("$cube"):
                value = out[w.L] * out[w.L] * out[w.L] * out_coeff
                if w.O in out:
                    if out[w.O] != value:
                        raise ValueError(
                            f"constraint violated: {w.O} = {out[w.O]} vs {value}"
                        )
                else:
                    out[w.O] = value
                continue
            pk = product_key(w.L, w.R)
            value = (
                Fr(coeffs.get("", 0))
                + out[w.L] * coeffs.get(w.L, 0)
                + out[w.R] * coeffs.get(w.R, 0) * (1 if w.R != w.L else 0)
                + out[w.L] * out[w.R] * coeffs.get(pk, 0)
            ) * out_coeff
            if w.O in out:
                if out[w.O] != value:
                    raise ValueError(
                        f"constraint violated: {w.O} = {out[w.O]} vs {value}"
                    )
            else:
                out[w.O] = value
        return {k: v.n for k, v in out.items()}
