"""Device-synchronized timers and a profiler trace.

Port of the JAX package's `utils/timing.py`: `tic`/`toc` bracket a region
with `sync`, which drains the card's queued work (nothing is queued on the
CPU), and read the host's clock; `profile_trace` records a torch.profiler
trace of the CPU and, where there is one, the card, written as a Chrome
trace (open it in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Dict, List

import torch

_stack: List[tuple] = []
stats: Dict[str, List[float]] = {}


def sync():
    """Drain all pending device work."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def tic(name: str = ""):
    sync()
    _stack.append((name, time.perf_counter()))


def toc(name: str = "", verbose: bool = True) -> float:
    sync()
    start_name, t0 = _stack.pop()
    dt = time.perf_counter() - t0
    label = name or start_name
    stats.setdefault(label, []).append(dt)
    if verbose:
        print(f"{label}: {dt * 1e3:.2f} ms")
    return dt


@contextlib.contextmanager
def timer(name: str, verbose: bool = False):
    tic(name)
    try:
        yield
    finally:
        toc(name, verbose=verbose)


@contextlib.contextmanager
def profile_trace(logdir):
    """Record a torch.profiler trace of the region into
    `<logdir>/trace.json` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            sync()
    prof.export_chrome_trace(str(path / "trace.json"))


def summary() -> str:
    lines = []
    for k, v in stats.items():
        lines.append(
            f"{k}: n={len(v)} mean={sum(v) / len(v) * 1e3:.2f}ms "
            f"min={min(v) * 1e3:.2f}ms max={max(v) * 1e3:.2f}ms"
        )
    return "\n".join(lines)
