"""The mul-chain: out = a^(n-3), one multiply gate a row, `out` public.

Frozen here (from chip_smoke.py's chain_lines / chain_witness) so that a
later change to the program or the smoke does not move the yardstick.
Sizes from the configuration: `group_order`."""

from __future__ import annotations

FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def lines(cfg: dict) -> list[str]:
    n = cfg["group_order"]
    out = ["out public", "c1 <== a * a"]
    out += [f"c{i} <== c{i-1} * a" for i in range(2, n - 3)]
    out.append(f"out <== c{n-4} * a")
    return out


def program_options(cfg: dict) -> dict:
    return {}


def table(cfg: dict):
    return None


def inputs(cfg: dict, rng) -> dict:
    """What a request brings: a field element a drawn from the seed."""
    return {"a": rng.randrange(2, FR_MOD)}


def witness(cfg: dict, inp: dict) -> dict:
    """The whole assignment: c_i = a^(i+1), out = a^(n-3)."""
    n, a = cfg["group_order"], inp["a"]
    w, acc = {"a": a}, a
    for i in range(1, n - 3):
        acc = acc * a % FR_MOD
        w[f"c{i}"] = acc
    w["out"] = acc * a % FR_MOD
    return w
