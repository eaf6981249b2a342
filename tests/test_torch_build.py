"""The build of the kernels and of the port's Tier-1 run (CPU).

The kernels' build is safe across processes: two processes that build at
the same time, as the ranks of a sharded proof do at their first launch,
run the compiler once and get one library.  A fake nvcc (found through
CUDA_HOME) records each call and sleeps, so the two builds overlap unless
the lock serializes them.

The port's test files keep the queue that PERF.md ("Tier-1 queue") lays
out: xdist (--dist loadfile) queues files by their count of tests,
largest first, ties by name.  No port file but the card's kernel tests
(which skip at once here) holds 7 or more Tier-1 tests, which would queue
it ahead of tests/test_sharded.py, the run's longest file; and the first
three port files of 6 tests stay collectives (taken while the JAX
package's test_ntt.py still runs), extension_algebra (its first four tests
keep the next worker busy past the moment test_sharded.py's worker takes
its one more file) and g1_cuda (that file: card tests, which skip here, so
the clock cuts no pass with them).
The counts are read by AST, without importing the files.
"""

import ast
import glob
import math
import multiprocessing
import os
import stat
import sys

from _torch_dist_worker import compile_in_child

FAKE_NVCC = """#!{python}
import os, sys, time
with open(os.environ["FAKE_NVCC_CALLS"], "a") as f:
    f.write("call\\n")
time.sleep(1.5)
with open(sys.argv[sys.argv.index("-o") + 1], "wb") as f:
    f.write(b"library")
print("ptxas info: fake")
"""


def test_two_processes_build_once(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    calls = tmp_path / "calls"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_CALLS", str(calls))
    build_dir = tmp_path / "build"
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=compile_in_child, args=(str(build_dir), str(tmp_path / f"result{i}")))
        for i in range(2)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    paths = {(tmp_path / f"result{i}").read_text() for i in range(2)}
    assert len(paths) == 1
    (path,) = paths
    assert os.path.dirname(path) == str(build_dir)
    with open(path, "rb") as f:
        assert f.read() == b"library"
    assert calls.read_text() == "call\n"
    assert sorted(os.listdir(build_dir)) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".log", "nvcc.lock"]
    )


def _is_slow(node) -> bool:
    """`pytest.mark.slow`, alone or in a list of marks."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return any(_is_slow(e) for e in node.elts)
    return isinstance(node, ast.Attribute) and node.attr == "slow"


def _cases(node, consts) -> int:
    """The cases of a parametrize argvalues node that are not slow."""
    if isinstance(node, ast.Name):
        node = consts[node.id]
    assert isinstance(node, (ast.List, ast.Tuple)), f"cannot count {ast.unparse(node)}"
    return sum(
        not (isinstance(e, ast.Call) and ast.unparse(e.func).endswith("param")
             and any(k.arg == "marks" and _is_slow(k.value) for k in e.keywords))
        for e in node.elts
    )


def tier1_count(path: str) -> int:
    """The tests of a file that `-m 'not slow'` collects: each test_*
    function's parametrize cases multiplied, slow ones left out."""
    with open(path) as f:
        tree = ast.parse(f.read())
    consts = {t.id: s.value for s in tree.body if isinstance(s, ast.Assign)
              for t in s.targets if isinstance(t, ast.Name)}
    total = 0
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        counts = []
        for d in fn.decorator_list:
            if _is_slow(d.func if isinstance(d, ast.Call) else d):
                counts = [0]
                break
            if isinstance(d, ast.Call) and ast.unparse(d.func).endswith("mark.parametrize"):
                counts.append(_cases(d.args[1], consts))
        total += math.prod(counts)
    return total


def test_port_files_keep_the_tier1_queue():
    here = os.path.dirname(os.path.abspath(__file__))
    counts = {os.path.basename(p): tier1_count(p)
              for p in sorted(glob.glob(os.path.join(here, "test_torch_*.py")))}
    assert counts["test_torch_kernels_cuda.py"] >= 7  # the AST count sees the cuda tests
    over = {f: n for f, n in counts.items() if n >= 7 and f != "test_torch_kernels_cuda.py"}
    assert not over, f"port files that queue ahead of tests/test_sharded.py: {over}"
    front = sorted(f for f, n in counts.items() if n == 6)[:3]
    assert front == ["test_torch_collectives.py", "test_torch_extension_algebra.py",
                     "test_torch_g1_cuda.py"], f"the queue's first port files changed: {front}"
