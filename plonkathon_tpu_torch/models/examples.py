"""Example circuit families exercised by tests and chip_smoke.py.

The same circuits as the JAX package's models/examples.py; each function
takes the `device` its Program's preprocessed polynomials live on ("cuda"
unless the caller asks for "cpu")."""

from __future__ import annotations

from ..frontend import Program

# e = (a*b)*d with e public.
THREE_GATE_SOURCE = ["e public", "c <== a * b", "e <== c * d"]

# Prove knowledge of 4-bit factors of a number.
FACTORIZATION_SOURCE = """n public
pb0 === pb0 * pb0
pb1 === pb1 * pb1
pb2 === pb2 * pb2
pb3 === pb3 * pb3
qb0 === qb0 * qb0
qb1 === qb1 * qb1
qb2 === qb2 * qb2
qb3 === qb3 * qb3
pb01 <== pb0 + 2 * pb1
pb012 <== pb01 + 4 * pb2
p <== pb012 + 8 * pb3
qb01 <== qb0 + 2 * qb1
qb012 <== qb01 + 4 * qb2
q <== qb012 + 8 * qb3
n <== p * q"""


def three_gate_program(group_order: int = 8, device="cuda") -> Program:
    return Program(list(THREE_GATE_SOURCE), group_order, device=device)


def factorization_program(group_order: int = 16, device="cuda") -> Program:
    return Program.from_str(FACTORIZATION_SOURCE, group_order, device=device)


def mul_chain_program(n_gates: int, group_order: int, device="cuda") -> Program:
    """Synthetic multiply-add chain of arbitrary size."""
    assert n_gates >= 2
    lines = ["x1 <== x0 * x0"]
    for i in range(2, n_gates):
        lines.append(f"x{i} <== x{i-1} * x{i-1} + {i}")
    return Program(lines, group_order, device=device)


def mul_chain_witness(program: Program, x0: int = 3) -> dict:
    return program.fill_variable_assignments({"x0": x0})


def turbo_lookup_program(
    n_gates: int, group_order: int, table_bits: int = 8, device="cuda"
) -> Program:
    """TurboPlonK cube gates + PlonKup lookups + vanilla mul-add rows in one
    circuit.

    Row mix: ~1/4 lookup rows (range-checked table inputs), the rest a
    squaring/cubing chain that folds the looked-up values in, so the
    lookup wires are copy-constrained into the arithmetic chain."""
    assert n_gates >= 8
    table = list(range(1 << table_bits))
    nlk = n_gates // 4
    lines = [f"t{j} lookup" for j in range(nlk)]
    rest = n_gates - nlk
    for i in range(rest):
        if i % 3 == 2:
            lines.append(f"y{i+1} <== y{i} * t{i % nlk} + y{i}")
        else:
            lines.append(f"y{i+1} <== y{i} * y{i} * y{i}")
    return Program(
        lines, group_order, custom_gates=True, lookup_table=table, device=device
    )


def turbo_lookup_witness(program: Program, y0: int = 3) -> dict:
    nlk = sum(
        1 for c in program.constraints if c.coeffs.get("$lookup")
    )
    mask = len(program.lookup_table) - 1  # table is a power-of-two range
    inputs = {f"t{j}": (j * 31 + 7) & mask for j in range(nlk)}
    inputs["y0"] = y0
    return program.fill_variable_assignments(inputs)


def cube_chain_program(n_gates: int, group_order: int, device="cuda") -> Program:
    """Repeated cubing via TurboPlonK custom cube gates: each row computes
    x_{i+1} = x_i^3 in ONE gate (three vanilla rows otherwise)."""
    assert n_gates >= 1
    lines = [f"x{i+1} <== x{i} * x{i} * x{i}" for i in range(n_gates)]
    return Program(lines, group_order, custom_gates=True, device=device)
