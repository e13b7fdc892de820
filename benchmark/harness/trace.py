"""The traced window: torch.profiler around a fixed stretch of the run, read
once from its raw events.

The arithmetic follows the port's `chip_smoke.trace_totals` (device events
summed by name from `kineto_results.events()`, not `key_averages()`, which
builds a tree of Python objects over every event) and adds the device's
busy time (the union of its operations' intervals), its idle gaps, and what
the host was doing in each gap (the innermost CUDA runtime call that spans
the gap's middle, or host code between calls). Only the device's activity
is recorded on a card: recording every host operation as well doubles the
host's cost of a training step and would be read as idle device time.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HOST_CODE = "host code between CUDA calls"
GAP_MIN_NS = 20_000  # idle gaps shorter than this are not labelled


class Tracer:
    """Profiles from `start()` to `stop()` and reads the window from
    `mark()` to `stop()`, so that the profiler's own start-up falls before
    the window; `enabled=False` makes all three no-ops. The device is
    synchronized at both ends of the window, so it holds all the device
    work enqueued inside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary = None

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.__enter__()

    def mark(self):
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.w0 = time.time_ns()

    def stop(self):
        if self.prof is None or self.summary is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        w1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.summary = reduce(self.prof, self.w0, w1)
        self.prof = None


def _merge(starts: np.ndarray, ends: np.ndarray):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx) if len(idx) else e[:0]


def reduce(prof, w0: int, w1: int) -> dict:
    """{window_s, busy_s, kernels: {name: [seconds, count]}, launches,
    device_ops: [[name, seconds]] (most time first), idle_gaps: [[host
    activity, seconds]] (summed by activity, most first)} of the window
    [w0, w1] (`time.time_ns()`, the profiler's time base)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        if e <= w0 or s >= w1:
            continue
        if ev.device_type() == cuda:
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not annotation and e > s:
                dev.append((s, e, ev.name()))
        else:
            host.append((s, e, ev.name()))
    kernels: dict = {}
    for s, e, name in dev:
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e9
        row[1] += 1
    launches = sum(n for name, (_, n) in kernels.items()
                   if not name.startswith(("Memcpy", "Memset")))
    out = dict(window_s=(w1 - w0) / 1e9, busy_s=0.0, kernels=kernels, launches=launches,
               device_ops=[[n, s] for n, (s, _) in sorted(kernels.items(),
                                                          key=lambda kv: -kv[1][0])[:10]],
               idle_gaps=[])
    if not dev:
        out["idle_gaps"] = [["no device work", out["window_s"]]]
        return out
    starts = np.clip(np.array([d[0] for d in dev], np.int64), w0, w1)
    ends = np.clip(np.array([d[1] for d in dev], np.int64), w0, w1)
    ms, me = _merge(starts, ends)
    out["busy_s"] = float((me - ms).sum()) / 1e9
    gap_s = np.concatenate([[w0], me])
    gap_e = np.concatenate([ms, [w1]])
    keep = (gap_e - gap_s) >= GAP_MIN_NS
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    if host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        hd = he - hs
        names = [h[2] for h in host]
    by_label: dict = {}
    longest = np.argsort(gap_s - gap_e)[:2000]
    for i in longest:
        mid = (gap_s[i] + gap_e[i]) // 2
        label = HOST_CODE
        if host:
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            if len(cover):
                label = names[cover[np.argmin(hd[cover])]]
        by_label[label] = by_label.get(label, 0.0) + float(gap_e[i] - gap_s[i]) / 1e9
    out["idle_gaps"] = [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]
    return out
