"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and compiles with nvcc into
its own shared library `build/kernels/lib<name>.so` at the repository root,
loaded with ctypes. A library is rebuilt when it is missing or older than
its source; `build()` starts one nvcc per stale source, all at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("attention", "attention_bwd", "tile_match")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_libs: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names=KERNELS, force: bool = False) -> dict:
    """Compile every stale library in `names` (every one with `force`) in
    parallel; returns {name: compiler output} for the ones built. Raises on
    any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = CSRC / f"{name}.cu", lib_path(name)
        if not force and out.is_file() and out.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library `name`, built on first use. `signatures` maps each
    C entry to its (argtypes, restype), set once when the library loads; a
    loaded library is returned without taking the lock."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def on_card(device):
    """The context in which a kernel launches on `device` (a torch.device or
    a card index; the C entries launch on the current card): none for a CPU
    device or for the card that is current already, so the common one-card
    call pays one query."""
    import torch

    index = device if isinstance(device, int) else device.index if device.type == "cuda" else -1
    if index is None or index < 0 or torch._C._cuda_getDevice() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)
