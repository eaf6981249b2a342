"""Build and load the hand-written Hopper kernels (`plonkathon_tpu_torch/csrc`).

The `csrc/*.cu` sources are compiled by one `nvcc` call into one shared
library with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`),
loaded with ctypes.  The library goes into the package's ignored `_build/`
directory under a name keyed by a hash of every source and header plus the
flags, so an edited kernel is never served from a stale build; nvcc's output
(the ptxas register and spill report) is kept beside it.  Nothing is built
when a module is imported: the first launch builds, or `build()` does it up
front.

Every C entry point returns `cudaGetLastError()` right after its launch;
`check()` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("mont.cu", "msm.cu", "msm3.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--threads", "0",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

# C signatures: name -> argtypes (pointers and the stream are c_void_p).
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
SIGNATURES = {
    "k1_mont_mul": [_P, _P, _P, _I64, _P, _P],
    "k2_dif_butterfly": [_P, _P, _P, _P, _P, _I64, _P, _P],
    "k7_jac_double_n": [_P, _P, _I64, _I32, _P, _P],
    "k5_jadd_stacked": [_P, _P, _P, _I64, _P, _P],
    "k6_run_scan": [_P, _P, _P, _P, _I64, _I64, _P, _P],
    "k3_madd_packed": [_P, _P, _P, _P, _I64, _I64, _P, _P],
    "k4_jadd_packed": [_P, _P, _P, _P, _I64, _I64, _P, _P],
    "k4_dense_buckets": [_P, _P, _P, _P, _I64, _I64, _I32, _P, _P],
    "k5_suffix_fold": [_P, _P, _P, _I64, _P, _P],
    "k8a_jac_add": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P],
    "k8a_window_sum": [_P, _P, _P, _P, _I64, _I32, _P, _P],
    "k8b_jac_madd": [_P, _P, _P, _P, _P, _P, _P, _I64, _P, _P],
    "k9_butterfly": [_P, _P, _P, _P, _P, _I64, _P, _P],
}

_lock = threading.Lock()
_lib = None

# Launch counts by kernel id (K1 per field; "K8a" is Setup.generate's window
# sum, "K8a add" the elementwise add).  A wrapper adds one where it launches
# its kernel and nowhere else, so a run can show which kernels its path went
# through.
LAUNCHES = {
    k: 0
    for k in ("K1 fr", "K1 fq", "K2", "K3", "K4", "K5", "K6", "K7", "K8a", "K8a add",
              "K8b", "K9")
}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")


def build() -> ctypes.CDLL:
    """Compile the sources (once per hash) and load the library.

    Raises RuntimeError with nvcc's output if the compile fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = _lib_path()
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"  # concurrent builders never see half a file
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            with open(out + ".log", "w") as f:
                f.write(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{proc.stdout[-8000:]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        for name, argtypes in SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
        return lib


def build_log() -> str:
    """nvcc's output (the ptxas register and spill report) of the build."""
    path = _lib_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def fn(name: str):
    """The C entry point `name` (builds the library at first use)."""
    return getattr(build(), name)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
