"""The control of `correct`, and the faults it has to catch.

The configurations state no floating-point precision: they state exact
arithmetic in Fr.  The control breaks that guarantee the way a tempting
shortcut would: `reduced_precision()` drops the lowest 16-bit limb of every
Fr Montgomery product the prover dispatches (`FieldOps.mul`, the
Montgomery-product kernel on the card), so products are exact to 240 bits
only.  The faults are the timed path broken underneath: `stale` (the entry
returns its first answer again and again), `half_batch` (half of a batch
proved, the rest filled with copies of those proofs) and `altered` (one
opening of each answer changed where it is produced).

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--sound]

runs the cell once a seed in one process under the control (or, with
--sound, as it stands) and prints each run's compared numbers."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


@contextlib.contextmanager
def reduced_precision():
    from plonkathon_tpu_torch.ops import limbs

    exact = limbs.FieldOps.mul

    def mul(self, a, b):
        out = exact(self, a, b)
        if self.name != "fr":
            return out
        out = out.clone()
        out[0] = 0
        return out

    limbs.FieldOps.mul = mul
    try:
        yield
    finally:
        limbs.FieldOps.mul = exact


def stale(entry):
    first = []

    def call(ws):
        if not first:
            first.append(entry(ws))
        return first[0]

    return call


def half_batch(entry):
    def call(ws):
        kept = entry(ws[: max(1, len(ws) // 2)])
        return (kept * len(ws))[: len(ws)]

    return call


def altered(entry):
    def call(ws):
        proofs = entry(ws)
        for p in proofs:
            p.msg_4.a_eval = p.msg_4.a_eval + 1
        return proofs

    return call


def main(argv=None) -> int:
    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sound", action="store_true", help="run the program as it stands")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 1
    cell = harness.resolve(harness.load_spec(), args.workload)
    for seed in args.seeds:
        ctx = contextlib.nullcontext() if args.sound else reduced_precision()
        try:
            with ctx:
                result, _ = harness.run(cell, seed, args.seconds, trace=False)
            line = {"seed": seed, "control": not args.sound, "correct": result["correct"],
                    "checks": result["checks"], "attempted": result["attempted"],
                    "metrics": result["metrics"]}
        except Exception as exc:  # a control that crashes has failed; record it and go on
            line = {"seed": seed, "control": not args.sound, "crashed": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
