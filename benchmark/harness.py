"""One run of one cell: set-up, warm-up, the measured window, an optional
traced stretch, the comparison with the plain reference, and the result
line.  Everything specific to a cell is data: BENCHMARK.json names the
cell's configuration and traffic; the configuration's file
(configs/<name>.json) its circuit family (families/<family>.py), sizes,
SRS size (`srs_powers`, else `group_order`) and judge (`reference`, a
module as check.py describes); the traffic file (workloads/<traffic>.json)
how requests are made and sent; each metric is read by metrics/<name>.py."""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import itertools
import json
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field

from . import check
from .reference.bn254 import R as FR_MOD

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "plonkathon_tpu")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell resolved from BENCHMARK.json: its entries and files."""

    name: str
    chips: int
    config: dict       # the configuration's file
    traffic: dict      # the traffic file
    end_to_end: list   # metric entries this cell reports with --trace 0
    per_layer: list    # ... and with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(spec: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"], config=load_json(conf["file"]),
        traffic=load_json(os.path.join("benchmark", "workloads", w["traffic"] + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def reader(name: str):
    """metrics/<name>.py's `read`."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Request:
    due: float                 # s from the window's start
    done: float = 0.0
    pool: list = field(default_factory=list)  # pool indices of its witnesses
    proofs: list = field(default_factory=list)
    error: str = ""


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)         # set-up spans, s
    requests: list = field(default_factory=list)      # the window's Requests
    window_s: float = 0.0
    sections: dict = field(default_factory=dict)      # Prover.timings over the window, s
    memory_peak_bytes: int = 0
    trace: object = None                              # trace.Trace of the traced stretch
    traced_proofs: int = 0

    @property
    def proofs(self) -> int:
        return sum(len(r.proofs) for r in self.requests)


def draw(seed: int, family, cfg: dict, traffic: dict):
    """tau, the pool's inputs and the request order, from the seed alone."""
    rng = random.Random(f"plonk-bench:{seed}")
    tau = rng.randrange(2, FR_MOD)
    inputs = [family.inputs(cfg, rng) for _ in range(traffic["pool"])]
    return tau, inputs, rng


def arrivals(traffic: dict, rng, seconds: float):
    """Due times of the requests, s from the window's start: None for a
    closed loop (each request as soon as the last returns); exponential
    gaps at `rate_per_s` for an open loop."""
    rate = traffic.get("rate_per_s")
    if not rate:
        return None
    t, out = 0.0, []
    while t < seconds:
        out.append(t)
        t += rng.expovariate(rate)
    return out


class _Spans:
    """Stand-in for Prover.timings in the traced stretch: the program's own
    sections, each also a profiler range under its name."""

    def __init__(self, base):
        self.base = base

    @contextlib.contextmanager
    def section(self, name):
        from torch.profiler import record_function

        with record_function(name), self.base.section(name):
            yield


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t0: float | None = None, fault=None, workers: int | None = None) -> tuple[dict, Run]:
    """Runs the cell; returns (the result line's object, the Run).  `fault`
    wraps the timed entry (tests break it to see `correct` turn false)."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from plonkathon_tpu_torch import Program, Prover, Setup
    from plonkathon_tpu_torch.parallel.batch import BatchProver
    from plonkathon_tpu_torch.utils.profiling import Timings

    cfg, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"benchmark.families.{cfg['family']}")
    on_card = device == "cuda"
    if on_card:
        from plonkathon_tpu_torch.ops import cuda_lib

        cuda_lib.build()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    r = Run(cell)
    tau, inputs, rng = draw(seed, family, cfg, traffic)
    n = cfg["group_order"]

    t = time.perf_counter()
    setup = Setup.generate(cfg.get("srs_powers", n), tau=tau, device=device)
    r.spans["srs_generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    program = Program(family.lines(cfg), n, device=device, **family.program_options(cfg))
    batch = traffic.get("batch", 0)
    if batch:
        prover = BatchProver(setup, program)
        base, entry = prover._prover, prover.prove_batch
    else:
        prover = Prover(setup, program, device=device)
        base, entry = prover, lambda ws: [prover.prove(ws[0])]
    r.spans["prover_init_s"] = time.perf_counter() - t
    pool = [family.witness(cfg, inp) for inp in inputs]
    if fault is not None:
        entry = fault(entry)
    width = max(batch, 1)
    order = list(range(len(pool)))
    rng.shuffle(order)
    turn = itertools.cycle(order)

    def next_ids():
        return [next(turn) for _ in range(width)]

    def call(ids):
        return entry([dict(pool[i]) for i in ids])

    # Warm-up: a cold request (the window tables) and a warm one.
    for _ in range(2):
        call(next_ids())
    if on_card:
        torch.cuda.synchronize()
    r.setup_s = time.perf_counter() - t0

    # The measured window.
    base.timings = Timings(base.device)
    due = arrivals(traffic, rng, seconds)
    start = time.perf_counter()
    k = 0
    while True:
        if due is not None:
            if k >= len(due):
                break
            wait = due[k] - (time.perf_counter() - start)
            if wait > 0:
                time.sleep(wait)
        req = Request(due=time.perf_counter() - start if due is None else due[k], pool=next_ids())
        try:
            req.proofs = list(call(req.pool))
        except Exception as exc:  # a request that fails is counted, and the run goes on
            req.error = f"{type(exc).__name__}: {exc}"
        req.done = time.perf_counter() - start
        r.requests.append(req)
        k += 1
        if due is None and req.done >= seconds:
            break
    r.window_s = r.requests[-1].done
    r.sections = dict(base.timings.sections)
    if trace:
        from .trace import traced

        plain = base.timings
        base.timings = _Spans(Timings(base.device))
        ids = [next_ids() for _ in range(traffic.get("trace_requests", 1))]
        r.trace = traced([(lambda i=i: call(i)) for i in ids])
        r.traced_proofs = width * len(ids)
        base.timings = plain
    if on_card:
        torch.cuda.synchronize()
        r.memory_peak_bytes = torch.cuda.max_memory_allocated()

    # The answers, as ints; then the program's state goes before the reference runs.
    answers, missing, attempted = [], 0, 0
    for req in r.requests:
        attempted += len(req.pool)
        got = [check.proof_ints(p) for p in req.proofs]
        missing += abs(len(req.pool) - len(got))
        answers += list(zip(req.pool, got))
        req.proofs = got
    del prover, base, entry, setup, program, pool
    if on_card:
        torch.cuda.empty_cache()
    sample = _sample(answers, traffic.get("check_sample", 8), seed)
    t = time.perf_counter()
    counts = {"proofs_missing": missing}
    counts.update(check.judge(cfg, tau, inputs, sample, answers,
                              len(os.sched_getaffinity(0)) if workers is None else workers))
    counts["proofs_checked"] = len(sample)
    print(f"benchmark: set-up {r.setup_s:.3f} s {json.dumps(r.spans)}; window {r.window_s:.3f} s, "
          f"{len(r.requests)} requests, {r.proofs} proofs; traced {r.traced_proofs} proofs; "
          f"reference {time.perf_counter() - t:.3f} s on {len(sample)} proofs; "
          f"latencies ms {[round((q.done - q.due) * 1e3) for q in r.requests]}",
          file=sys.stderr)
    errors = [q.error for q in r.requests if q.error]
    if errors:
        print(f"benchmark: {len(errors)} requests failed, the first: {errors[0]}", file=sys.stderr)
    result = _result(cell, r, counts, attempted, trace, on_card)
    return result, r


def _sample(answers: list, cap: int, seed: int) -> list:
    """The distinct (pool index, proof) pairs among the answers, and of
    them at most `cap`, drawn from the seed.  A proof equal to one judged
    is judged alike, so only the distinct ones are worth the reference's
    time."""
    distinct, seen = [], set()
    for idx, proof in answers:
        key = (idx, json.dumps(proof, sort_keys=True))
        if key not in seen:
            seen.add(key)
            distinct.append((idx, proof))
    rng = random.Random(f"plonk-bench-sample:{seed}")
    return rng.sample(distinct, min(cap, len(distinct)))


def _device(on_card: bool) -> dict:
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    kind = torch.cuda.get_device_name(0)
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"platform": "gpu", "kind": kind, "count": 1, "power_limit_w": limit}


def _result(cell: Cell, r: Run, counts: dict, attempted: int, trace: bool, on_card: bool) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": counts[k], "limit": lim} for k, lim in check.limits(cell.config).items()}
    checks["proofs_checked"] = {"value": counts["proofs_checked"], "at_least": 1}
    correct = all(c["value"] <= c["limit"] for c in checks.values() if "limit" in c)
    correct = correct and counts["proofs_checked"] >= 1
    device = _device(on_card)
    device["memory_peak_bytes"] = r.memory_peak_bytes
    out = {"correct": correct, "attempted": attempted, "failed": counts["proofs_missing"],
           "metrics": metrics, "device": device}
    if trace and r.trace is not None:
        from .trace import breakdown

        device["busy_s"] = r.trace.busy_s()
        device["window_s"] = r.trace.window_s
        out["breakdown"] = breakdown(r.trace)
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = resolve(load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    result, _ = run(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        print(f"check {name} {c['value']} ({bound})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
