"""The kernels' build is safe across processes (CPU): two processes that
build at the same time, as the ranks of a sharded proof do at their first
launch, run the compiler once and get one library.  A fake nvcc (found
through CUDA_HOME) records each call and sleeps, so the two builds
overlap unless the lock serializes them.
"""

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
