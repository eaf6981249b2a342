"""A judge of blinded (zero-knowledge) chain proofs for the harness tests,
named by a configuration's `reference` as any judge is (benchmark/check.py).
It holds the blinding guarantee alone, not the protocol's values:

* `wires_unblinded`: each of a_1, b_1, c_1 that equals p(tau) G of its
  column with the blinding rows left zero, i.e. carries no blinder;
* `a_1_repeated` (across the window): each proof whose a_1 an earlier
  proof of the same witness had; fresh blinders never repeat."""

from ..reference.bn254 import R, dot, mul_g
from ..reference.plonk import Circuit, _lagrange_at

LIMITS = {
    "wires_unblinded": 0,
    "a_1_repeated": 0,
}


class _Judge:
    def __init__(self, circuit: Circuit, tau: int):
        self.circuit = circuit
        self.lt = _lagrange_at(circuit, tau % R)  # L_i(tau) for every row i

    def check(self, proof: dict, inputs: dict) -> dict:
        plain = (mul_g(dot(v, self.lt)) for v in self.circuit.columns(inputs)[:3])
        return {"wires_unblinded": sum(proof[k] == p for k, p in zip(("a_1", "b_1", "c_1"), plain))}


def checker(lines: list[str], cfg: dict, table, tau: int) -> _Judge:
    return _Judge(Circuit(lines, cfg["group_order"], table=table), tau)


def across(answers: list, inputs: list) -> dict:
    seen, repeated = set(), 0
    for index, proof in answers:
        repeated += (index, proof["a_1"]) in seen
        seen.add((index, proof["a_1"]))
    return {"a_1_repeated": repeated}
