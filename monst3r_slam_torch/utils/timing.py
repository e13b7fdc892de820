"""The port's one recorder of program spans and counters, on the profiler's
clock.

Every span and counter of the port lands in one process-wide buffer:

* `span(name, rid=None, device=False, log=None)` is a context manager that
  records the span's name, its thread (the native thread id, as the
  profiler's trace names threads), its parent (the enclosing span on the
  same thread), a request id (`rid`: the frame id in SLAM, the step in
  training; by default the parent's), and its start and end in ns. With
  `device=True` it also records a pair of CUDA events (from a pool) at its
  two ends, on the stream current at its start; they are read without
  blocking, as later device spans end and find them reached, or at the
  first read of the buffer, which waits for the ones left. `log`, a list,
  receives the span's host ms when its block ends without an exception.
  `start()` and `stop()` open and close a span whose ends are not one
  block.
* `count(name, n=1)` records an instant event in the same buffer, so a
  reader selects counters by time as it selects spans.
* `spans()`, `counts()` and `reset()` read and clear the buffer;
  `summary()` is a table by name (count, median and 95th percentile host
  ms, self ms: a span's time less its child spans', device ms).
* `profile_trace(logdir)` records a torch.profiler trace of a region and
  writes it, with the region's program spans on rows of their own, to
  `<logdir>/trace.json`.

Times are `time.perf_counter_ns()` plus one offset to `time.time_ns()`
taken at import: the base that torch.profiler's events read, so program
spans line up with the trace's host and device events. The buffer keeps
the newest `CAPACITY` records. Set `enabled = False` and `span` returns one
shared no-op context, `count` returns at once, and nothing is recorded.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import pathlib
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

enabled = True
CAPACITY = 1 << 20

_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # guards the device spans not read yet and the event pool
_pending: collections.deque = collections.deque()
_pool: dict = {}  # device index -> free (start, end) event pairs


def now_ns() -> int:
    """The recorder's clock: ns on `time.time_ns()`'s base."""
    return time.perf_counter_ns() + _OFFSET_NS


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Count(NamedTuple):
    name: str
    n: int
    t: int  # ns
    tid: int
    parent: Optional[int]  # the enclosing span's sid
    rid: object


class Span:
    """One span; a record of the buffer once it has ended. `device_ms` is
    the time between its two events on the stream (None without them, or
    until read)."""

    __slots__ = ("name", "rid", "sid", "parent", "tid", "t0", "t1", "device_ms", "_device",
                 "_events", "_stream", "_log")

    def __init__(self, name: str, rid=None, device: bool = False, log: Optional[list] = None):
        self.name, self.rid, self._device, self._log = name, rid, device, log
        self.sid = self.parent = self.tid = self.t0 = self.t1 = None
        self.device_ms = self._events = self._stream = None

    @property
    def ms(self) -> float:
        """Host ms; 0 until the span has ended."""
        return (self.t1 - self.t0) / 1e6 if self.t1 is not None else 0.0

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            top = st[-1]
            self.parent = top.sid
            if self.rid is None:
                self.rid = top.rid
        self.sid = next(_ids)
        self.tid = threading.get_native_id()
        st.append(self)
        if self._device:
            self._stream = torch.cuda.current_stream()
            self._events = _take_events(self._stream.device_index)
            self._events[1].record(self._stream)
        self.t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = now_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        if self._events is not None:
            self._events[2].record(self._stream)
            self._stream = None
            with _lock:
                _pending.append(self)
                _poll()
        _records.append(self)
        if self._log is not None and exc_type is None:
            self._log.append(self.ms)
        return False

    def start(self) -> "Span":
        return self.__enter__()

    def stop(self) -> None:
        """End the span (once; later calls do nothing)."""
        if self.t1 is None and self.t0 is not None:
            self.__exit__(None, None, None)


class _Off:
    """The shared no-op context `span` returns while recording is off."""

    ms = 0.0
    device_ms = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def start(self):
        return self

    def stop(self):
        pass


_OFF = _Off()


def span(name: str, rid=None, device: bool = False, log: Optional[list] = None):
    """A span context (module docstring); the shared no-op while off."""
    if not enabled:
        return _OFF
    return Span(name, rid, device, log)


def count(name: str, n: int = 1) -> None:
    """An instant event of `n` under `name`, in the enclosing span."""
    if not enabled:
        return
    st = _stack()
    top = st[-1] if st else None
    _records.append(Count(name, int(n), now_ns(), threading.get_native_id(),
                          top.sid if top is not None else None,
                          top.rid if top is not None else None))


def _take_events(dev: int) -> tuple:
    with _lock:
        free = _pool.setdefault(dev, [])
        if free:
            return free.pop()
    return (dev, torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))


def _resolve(s: Span) -> None:
    ev = s._events
    s.device_ms = ev[1].elapsed_time(ev[2])
    s._events = None
    _pool.setdefault(ev[0], []).append(ev)


def _poll() -> None:
    """Read the oldest device spans whose end the stream has reached
    (caller holds `_lock`)."""
    while _pending and _pending[0]._events[2].query():
        _resolve(_pending.popleft())


def _drain() -> None:
    """Wait for the device spans not read yet, then read them."""
    with _lock:
        while _pending:
            s = _pending.popleft()
            s._events[2].synchronize()
            _resolve(s)


def spans(name: Optional[str] = None) -> list:
    """The buffer's ended spans in the order they ended (of `name` only,
    if given), each device span's time read."""
    _drain()
    return [r for r in list(_records) if type(r) is Span and (name is None or r.name == name)]


def counts(name: Optional[str] = None) -> list:
    """The buffer's counter events (of `name` only, if given)."""
    return [r for r in list(_records) if type(r) is Count and (name is None or r.name == name)]


def reset() -> None:
    """Drop every record, and the device spans not read yet."""
    with _lock:
        _pending.clear()
    _records.clear()


def self_ns(rows: list) -> dict:
    """sid -> each span's ns less the ns of its child spans among `rows`."""
    child: dict = {}
    for s in rows:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + (s.t1 - s.t0)
    return {s.sid: (s.t1 - s.t0) - child.get(s.sid, 0) for s in rows}


def summary() -> str:
    """Per span name: count, median and 95th-percentile host ms, total self
    ms, median device ms; then each counter's total."""
    rows = spans()
    own = self_ns(rows)
    by: dict = {}
    for s in rows:
        by.setdefault(s.name, []).append(s)
    lines = [f"{'span':24s} {'n':>7s} {'median_ms':>10s} {'p95_ms':>10s} {'self_ms':>12s} "
             f"{'device_ms':>10s}"]
    for name, ss in by.items():
        ms = np.array([s.ms for s in ss])
        dev = [s.device_ms for s in ss if s.device_ms is not None]
        lines.append(f"{name:24s} {len(ss):7d} {np.median(ms):10.3f} "
                     f"{np.percentile(ms, 95):10.3f} {sum(own[s.sid] for s in ss) / 1e6:12.3f} "
                     f"{np.median(dev) if dev else float('nan'):10.3f}")
    totals: dict = {}
    for c in counts():
        totals[c.name] = totals.get(c.name, 0) + c.n
    lines += [f"{name:24s} {n:7d} (counter total)" for name, n in totals.items()]
    return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(logdir):
    """Record a torch.profiler trace of the region (the CPU, and the card
    where there is one) into `<logdir>/trace.json` (Chrome trace format:
    chrome://tracing or Perfetto), with the program spans that overlap the
    region as complete events on rows of their own, one a thread, on the
    trace's time base."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    t0 = now_ns()
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    t1 = now_ns()
    out = path / "trace.json"
    prof.export_chrome_trace(str(out))
    _write_spans(out, [s for s in spans() if s.t1 >= t0 and s.t0 <= t1])


SPAN_ROW = 1 << 31  # a program span row's tid: the thread's native id plus this


def _write_spans(trace_json, rows: list) -> None:
    """Add `rows` (spans) to a Chrome trace that torch.profiler exported, as
    complete events of the trace's own process, each thread's spans on a
    row of its own."""
    trace_json = pathlib.Path(trace_json)
    doc = json.loads(trace_json.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = next((e["pid"] for e in doc["traceEvents"] if e.get("cat") == "cpu_op"), 0)
    events = doc["traceEvents"]
    for tid in sorted({s.tid for s in rows}):
        events.append(dict(ph="M", name="thread_name", pid=pid, tid=SPAN_ROW + tid,
                           args=dict(name=f"program spans, thread {tid}")))
    for s in rows:
        rid = s.rid if s.rid is None or isinstance(s.rid, (int, str)) else str(s.rid)
        args = dict(sid=s.sid, parent=s.parent, rid=rid)
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append(dict(ph="X", cat="program_span", name=s.name, pid=pid,
                           tid=SPAN_ROW + s.tid, ts=(s.t0 - base) / 1e3,
                           dur=(s.t1 - s.t0) / 1e3, args=args))
    trace_json.write_text(json.dumps(doc))
