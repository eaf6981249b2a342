"""Poseidon hash: host implementation + PLONK circuit generator.

Parameters (the constants in data/poseidon_rc.json): t = 3, alpha = 5,
8 full rounds (4 + 4), 56 partial rounds, MDS row built from 1/3..1/7.

The circuit (one constraint per multiplication, ~900 gates at n = 1024)
proves one Poseidon execution; it is the largest end-to-end workload of
the tests.
"""

from __future__ import annotations

import json
import os

from ..fields import Fr

_RC_PATH = os.path.join(os.path.dirname(__file__), "data", "poseidon_rc.json")

with open(_RC_PATH) as _f:
    ROUND_CONSTANTS = [[Fr(a), Fr(b), Fr(c)] for (a, b, c) in json.load(_f)]
MDS_ROW = [Fr(1) / i for i in range(3, 8)]

N_ROUNDS = 64


def FULL_ROUND(i: int) -> bool:
    return i < 4 or i >= 60


def poseidon_hash(in1, in2) -> Fr:
    """Host-side Poseidon(t=3) of two field elements; returns the M lane."""
    state = [Fr(in1), Fr(in2), Fr(0)]
    for i in range(N_ROUNDS):
        state[0] = (state[0] + ROUND_CONSTANTS[i][0]) ** 5
        state[1] = state[1] + ROUND_CONSTANTS[i][1]
        state[2] = state[2] + ROUND_CONSTANTS[i][2]
        if FULL_ROUND(i):
            state[1] = state[1] ** 5
            state[2] = state[2] ** 5
        state = [
            state[0] * MDS_ROW[0] + state[1] * MDS_ROW[1] + state[2] * MDS_ROW[2],
            state[0] * MDS_ROW[1] + state[1] * MDS_ROW[2] + state[2] * MDS_ROW[3],
            state[0] * MDS_ROW[2] + state[1] * MDS_ROW[3] + state[2] * MDS_ROW[4],
        ]
    return state[1]


def poseidon_circuit_source() -> str:
    """DSL source proving one Poseidon execution (x^5 via three mul gates).

    Wire naming: lanes L/M/R per round; `Ladj` = lane + round constant,
    `Lsq` = adj^2, `Lqd` = sq^2, `Lqn` = qd*adj (= adj^5); MDS mix written
    as a chain of two-term linear gates.
    """
    lines = ["L0 public", "M0 public", "M64 public", "R0 <== 0"]
    for i in range(N_ROUNDS):
        for j, lane in enumerate(("L", "M", "R")):
            rc = ROUND_CONSTANTS[i][j].n
            if lane == "L" or FULL_ROUND(i):
                lines.append(f"{lane}adj{i} <== {lane}{i} + {rc}")
                lines.append(f"{lane}sq{i} <== {lane}adj{i} * {lane}adj{i}")
                lines.append(f"{lane}qd{i} <== {lane}sq{i} * {lane}sq{i}")
                lines.append(f"{lane}qn{i} <== {lane}qd{i} * {lane}adj{i}")
            else:
                lines.append(f"{lane}qn{i} <== {lane}{i} + {rc}")
        for j, lane in enumerate(("L", "M", "R")):
            m0, m1, m2 = (MDS_ROW[j].n, MDS_ROW[j + 1].n, MDS_ROW[j + 2].n)
            lines.append(f"{lane}suma{i} <== Lqn{i} * {m0}")
            lines.append(f"{lane}sumb{i} <== {lane}suma{i} + Mqn{i} * {m1}")
            lines.append(f"{lane}{i + 1} <== {lane}sumb{i} + Rqn{i} * {m2}")
    return "\n".join(lines)
