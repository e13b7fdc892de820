"""Build and load the native f64 host solver (`solver.cpp`).

g++ compiles it at first use into `build/native/libmonst3r_native.so` at the
repository root (never into the source tree), and again when the library is
older than its source. `-march=native` fits the library to the machine that
builds it, which is the machine that runs it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "solver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB = BUILD_DIR / "libmonst3r_native.so"

_lib = None
_lock = threading.Lock()
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(SRC), "-o", str(tmp)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"native solver build failed ({' '.join(cmd)}):\n{out.stderr}")
    os.replace(tmp, LIB)  # atomic: a concurrent build never sees a partial file


def load_solver() -> ctypes.CDLL:
    """The solver library, built on first use; raises if it cannot build."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not LIB.is_file() or LIB.stat().st_mtime < SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIB))
            lib.solve_spd_f64.restype = ctypes.c_int64
            lib.solve_spd_f64.argtypes = [_DOUBLE_P, _DOUBLE_P, _DOUBLE_P, ctypes.c_int64,
                                          ctypes.c_double]
            _lib = lib
    return _lib


def solver_available() -> bool:
    """True when the solver builds and loads on this machine."""
    try:
        load_solver()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def solve_spd(A: np.ndarray, b: np.ndarray, jitter: float = 0.0) -> np.ndarray:
    """Solve SPD A x = b in float64; raises `np.linalg.LinAlgError` when the
    factorization fails even with the jitter grown three times."""
    lib = load_solver()
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    n = A.shape[0]
    if A.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"solve_spd needs A (n, n) and b (n,), got {A.shape} and {b.shape}")
    x = np.zeros(n, np.float64)
    rc = lib.solve_spd_f64(A.ctypes.data_as(_DOUBLE_P), b.ctypes.data_as(_DOUBLE_P),
                           x.ctypes.data_as(_DOUBLE_P), n, jitter)
    if rc != 0:
        raise np.linalg.LinAlgError("native SPD solve failed")
    return x
