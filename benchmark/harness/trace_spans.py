"""The device time of the program's spans in the traced frames.

The recorder's device spans (`device_ms`) time the stream between two CUDA
events, so on a frame paced by the host they also hold every gap the host
leaves while it enqueues the span's work. The dynamic cell's readers read
the trace instead. Each device operation of the traced frames is tied by
its correlation id to the CUDA runtime call that launched it, and a span's
device time is the device's busy time (the union of the intervals) of the
operations that the main thread launched while the span was open. The main
thread's id in the trace is the thread that launched a marker kernel,
which `SpanTracer.mark` enqueues just before the window. Only the main
thread's launches are kept: the tracking path's spans run there, and the
backend's worker launches on its own thread at the same time.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import spans
from benchmark.harness.trace import Tracer, _merge

MARKER = "spin"  # `torch.cuda._sleep`'s kernel


class SpanTracer(Tracer):
    """A `Tracer` that also keeps, in `launched`, the device operations of
    the window that the main thread launched: {start, end, launch} (ns
    arrays, the launch being the runtime call's host start). None before
    `stop`, on the CPU, or where the trace does not tie the marker to one
    thread."""

    launched = None
    _marker = None

    def mark(self):
        if self.prof is not None and torch.cuda.is_available():
            m0 = time.time_ns()
            torch.cuda._sleep(1000)
            self._marker = (m0, time.time_ns())
        super().mark()

    def stop(self):
        prof = self.prof
        super().stop()
        if prof is not None and self._marker is not None:
            self.launched = launched_ops(prof.profiler.kineto_results.events(), self._marker,
                                         self.w0)


def launched_ops(events, marker, w0: int) -> Optional[dict]:
    """{start, end, launch} of the device operations from `w0` on that the
    marker's thread launched, from torch.profiler's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    calls: dict = {}  # correlation id -> (host start, thread)
    ops = []
    for ev in events:
        if ev.device_type() == cuda:
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not annotation and ev.end_ns() > ev.start_ns():
                ops.append((ev.start_ns(), ev.end_ns(), ev.correlation_id(), ev.name()))
        elif ev.correlation_id():
            calls.setdefault(ev.correlation_id(), (ev.start_ns(), ev.start_thread_id()))
    m0, m1 = marker
    main = {calls[c][1] for _, _, c, name in ops
            if MARKER in name and c in calls and m0 <= calls[c][0] <= m1}
    if len(main) != 1:
        return None
    main = main.pop()
    rows = [(s, e, calls[c][0]) for s, e, c, _ in ops
            if s >= w0 and c in calls and calls[c][1] == main]
    if not rows:
        return None
    a = np.array(rows, np.int64)
    return dict(start=a[:, 0], end=a[:, 1], launch=a[:, 2])


def busy_ms(launched: dict, t0: int, t1: int) -> float:
    """The device's busy ms of the operations launched in [t0, t1]."""
    sel = (launched["launch"] >= t0) & (launched["launch"] <= t1)
    if not sel.any():
        return 0.0
    s, e = _merge(launched["start"][sel], launched["end"][sel])
    return float((e - s).sum()) / 1e6


def traced(run: dict, rec=None) -> Optional[spans.Window]:
    """The traced frames' spans: the last `traced_frames` `frame` spans of
    the main thread (the one before them starts the profiler) and every
    span inside them. None without a recorder, a trace that ties launches
    to threads, or the traced frames."""
    rec = spans.store() if rec is None else rec
    n = run.get("traced_frames")
    if rec is None or not n or run.get("launched") is None:
        return None
    main = threading.main_thread().native_id
    rows = rec.spans()
    tops = sorted((s for s in rows if s.name == "frame" and s.tid == main and s.parent is None),
                  key=lambda s: s.t0)
    if len(tops) < n:
        return None
    chosen = tops[-n:]
    lo, hi = chosen[0].t0, chosen[-1].t1
    return spans.Window(chosen, [s for s in rows if s.t0 >= lo and s.t1 <= hi], [], main)


def span_busy_ms(run: dict, name: str) -> list:
    """(span, device busy ms) of the traced frames' main-thread spans `name`."""
    w = traced(run)
    if w is None:
        return []
    return [(s, busy_ms(run["launched"], s.t0, s.t1)) for s in spans.main_thread(w, name)]
