"""Worker time of a pytest run, by test file, from its --junitxml file(s).

    python scripts/tier1_times.py RUN.xml [OTHER.xml ...]

Each test case's `time` (its setup, call and teardown) is summed by file;
prints one column per XML file, then the totals of the port's files
(tests/test_torch_*.py, the ranks they spawn included, as the test that
spawns them waits), of the JAX package's, `tests/test_sharded.py` alone
and the suite's wall (the testsuite's `time`).  Under xdist a file's sum
is the time its worker spent on it, so the totals are worker time, not
wall.
"""

from __future__ import annotations

import collections
import sys
import xml.etree.ElementTree as ET


def load(path: str):
    """(seconds by test file, the testsuite's wall) of one junit file."""
    per = collections.Counter()
    root = ET.parse(path).getroot()
    suites = [root] if root.tag == "testsuite" else list(root.iter("testsuite"))
    wall = sum(float(s.get("time", 0)) for s in suites)
    for case in root.iter("testcase"):
        parts = case.get("classname", "").split(".")
        name = "/".join(parts[:2]) + ".py" if len(parts) >= 2 else parts[0]
        per[name] += float(case.get("time", 0))
    return per, wall


def main(paths: list[str]) -> None:
    runs = [load(p) for p in paths]
    files = sorted(set().union(*(per for per, _ in runs)), key=lambda f: -runs[0][0][f])
    width = max(len(f) for f in files)
    for f in files:
        print(f"{f:{width}s}", " ".join(f"{per[f]:9.1f}" for per, _ in runs))
    rows = {
        "port (tests/test_torch_*.py)": lambda f: "/test_torch_" in f,
        "JAX package's tests": lambda f: "/test_torch_" not in f,
        "tests/test_sharded.py": lambda f: f == "tests/test_sharded.py",
    }
    for label, pick in rows.items():
        print(f"{label:{width}s}", " ".join(
            f"{sum(v for f, v in per.items() if pick(f)):9.1f}" for per, _ in runs))
    print(f"{'wall (testsuite time)':{width}s}", " ".join(f"{wall:9.1f}" for _, wall in runs))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
