"""Native (C) runtime components, built on demand with a Python fallback.

Currently: the Keccak-f[1600] permutation behind the Merlin transcript.
The shared object is compiled once into the package's ignored build
directory (`plonkathon_tpu_torch/_build/`) with the system C compiler and
loaded via ctypes; any failure falls back silently to the pure-Python
implementation (identical semantics).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "keccak1600.c")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "_keccak1600.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return True
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["cc", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=60,
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_keccak():
    """Returns a callable(bytearray200) -> None, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            so = ctypes.CDLL(_SO)
            fn = so.keccak_f1600
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = None
        except (OSError, AttributeError):
            return None

        def permute(state: bytearray) -> None:
            # Per-call buffer: a shared module-level buffer would race
            # between concurrent transcripts.
            buf = ctypes.create_string_buffer(bytes(state), 200)
            fn(buf)
            state[:] = buf.raw[:200]

        _lib = permute
        return _lib
