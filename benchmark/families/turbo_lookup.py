"""TurboPlonK cube gates with PlonKup lookups, the rows of the program's
`models.examples.turbo_lookup_program(n_gates, group_order, table_bits)`:
a quarter of the gates look a value up in 0 ... 2^table_bits - 1, the rest
cube a running value y, every third a mul-add row y' = y * t + y that folds
a looked-up value in.  The looked-up values are fixed, spread over the
table; y0 is drawn from the seed.  Sizes from the configuration:
`group_order`, `n_gates`, `table_bits`."""

from __future__ import annotations

FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def lines(cfg: dict) -> list[str]:
    n_gates = cfg["n_gates"]
    nlk = n_gates // 4
    out = [f"t{j} lookup" for j in range(nlk)]
    for i in range(n_gates - nlk):
        if i % 3 == 2:
            out.append(f"y{i+1} <== y{i} * t{i % nlk} + y{i}")
        else:
            out.append(f"y{i+1} <== y{i} * y{i} * y{i}")
    return out


def table(cfg: dict) -> list[int]:
    return list(range(1 << cfg["table_bits"]))


def program_options(cfg: dict) -> dict:
    return {"custom_gates": True, "lookup_table": table(cfg)}


def inputs(cfg: dict, rng) -> dict:
    mask = (1 << cfg["table_bits"]) - 1
    inp = {f"t{j}": (j * 31 + 7) & mask for j in range(cfg["n_gates"] // 4)}
    inp["y0"] = rng.randrange(2, FR_MOD)
    return inp


def witness(cfg: dict, inp: dict) -> dict:
    nlk = cfg["n_gates"] // 4
    w = dict(inp)
    y = inp["y0"] % FR_MOD
    for i in range(cfg["n_gates"] - nlk):
        if i % 3 == 2:
            y = (y * w[f"t{i % nlk}"] + y) % FR_MOD
        else:
            y = y * y % FR_MOD * y % FR_MOD
        w[f"y{i+1}"] = y
    return w
