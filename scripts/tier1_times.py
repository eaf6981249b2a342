"""Worker time of a pytest run, by test file, from its --junitxml file(s),
and with the run's -v log, each xdist worker's timeline.

    python scripts/tier1_times.py RUN.xml [OTHER.xml ...] [--log RUN.log] [--clock 1470]

Each test case's `time` (its setup, call and teardown) is summed by file;
prints one column per XML file, then the totals of the port's files
(tests/test_torch_*.py, the ranks they spawn included, as the test that
spawns them waits), of the JAX package's, `tests/test_sharded.py` alone
and the suite's wall (the testsuite's `time`).  Under xdist a file's sum
is the time its worker spent on it, so the totals are worker time, not
wall.

With `--log`, the -v log of the first XML's run (`pytest -v -n 6 --dist
loadfile ...`: xdist prints `[gwN] [ x%] PASSED tests/f.py::test` as each
test ends) gives each worker's tests in the order it ran them.  Summing
their junit times in that order rebuilds each worker's files with their
start and end.  The timeline starts at the wall less the longest worker's
sum, which is the start-up (collection, worker imports) if that worker
never waited.  It then prints which files were still running at the
clock (`--clock`, default 1470 s, the Tier-1 limit) and how many tests
had passed by then.
"""

from __future__ import annotations

import argparse
import collections
import re
import xml.etree.ElementTree as ET

LOG_LINE = re.compile(r"\[(gw\d+)\] \[ *\d+%\] (PASSED|FAILED|ERROR|SKIPPED|XFAIL|XPASS) (\S+)")


def _case_id(case) -> tuple[str, str]:
    """(test file, its node id) of a junit testcase."""
    parts = case.get("classname", "").split(".")
    path = "/".join(parts[:2]) + ".py" if len(parts) >= 2 else parts[0]
    return path, f"{path}::{case.get('name')}"


def load(path: str):
    """(seconds by test file, the testsuite's wall, seconds by node id)."""
    per, cases = collections.Counter(), {}
    root = ET.parse(path).getroot()
    suites = [root] if root.tag == "testsuite" else list(root.iter("testsuite"))
    wall = sum(float(s.get("time", 0)) for s in suites)
    for case in root.iter("testcase"):
        name, node = _case_id(case)
        per[name] += float(case.get("time", 0))
        cases[node] = cases.get(node, 0.0) + float(case.get("time", 0))
    return per, wall, cases


def timeline(log_path: str, cases: dict, wall: float, clock: float) -> None:
    """Each worker's files in the order it ran them, with start and end."""
    runs = collections.defaultdict(list)  # worker -> [(node, outcome)]
    with open(log_path, errors="replace") as f:
        for line in f:
            m = LOG_LINE.search(line)
            if m:
                runs[m.group(1)].append((m.group(3), m.group(2)))
    totals = {w: sum(cases.get(node, 0.0) for node, _ in seq) for w, seq in runs.items()}
    start = max(0.0, wall - max(totals.values()))
    print(f"\ntimeline (start-up {start:.1f} s = wall - longest worker's sum; "
          f"* = still running at {clock:g} s)")
    passed_by_clock, late = 0, []
    for w in sorted(runs, key=lambda w: int(w[2:])):
        t = start
        spans = []  # [file, start, end, tests]
        for node, outcome in runs[w]:
            path = node.split("::")[0]
            if not spans or spans[-1][0] != path:
                spans.append([path, t, t, 0])
            t += cases.get(node, 0.0)
            spans[-1][2:] = [t, spans[-1][3] + 1]
            passed_by_clock += outcome == "PASSED" and t <= clock
        print(f"{w}: {len(runs[w])} tests, ends at {t:.1f} s")
        for path, s, e, n in spans:
            mark = "*" if e > clock else " "
            if e > clock:
                late.append((path, w, s, e))
            print(f"  {mark} {s:8.1f} {e:8.1f} {e - s:8.1f}  {n:3d}  {path}")
    print(f"files still running at {clock:g} s: "
          + (", ".join(f"{p} ({w}, {s:.0f}-{e:.0f} s)" for p, w, s, e in late) or "none"))
    print(f"tests passed by {clock:g} s: {passed_by_clock}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", nargs="+")
    ap.add_argument("--log", help="the -v log of the first XML's run")
    ap.add_argument("--clock", type=float, default=1470.0)
    args = ap.parse_args()
    runs = [load(p) for p in args.xml]
    files = sorted(set().union(*(per for per, _, _ in runs)), key=lambda f: -runs[0][0][f])
    width = max(len(f) for f in files)
    for f in files:
        print(f"{f:{width}s}", " ".join(f"{per[f]:9.1f}" for per, _, _ in runs))
    rows = {
        "port (tests/test_torch_*.py)": lambda f: "/test_torch_" in f,
        "JAX package's tests": lambda f: "/test_torch_" not in f,
        "tests/test_sharded.py": lambda f: f == "tests/test_sharded.py",
    }
    for label, pick in rows.items():
        print(f"{label:{width}s}", " ".join(
            f"{sum(v for f, v in per.items() if pick(f)):9.1f}" for per, _, _ in runs))
    print(f"{'wall (testsuite time)':{width}s}", " ".join(f"{wall:9.1f}" for _, wall, _ in runs))
    if args.log:
        _, wall, cases = runs[0]
        timeline(args.log, cases, wall, args.clock)


if __name__ == "__main__":
    main()
