"""The program's own spans and counters in the measured window, for the
per-layer metrics that read the port's recorder
(`monst3r_slam_torch/utils/timing.py`).

The recorder is process-wide and on by default, so after a run it holds
the set-up's, the window's and the traced frames' or steps' records. The
window's are found by the spans that each cover one frame (`frame` on the
main thread) or one training step (`train_step`): the run's `frames` (or
`steps`) of them that come just before the last `traced_frames + 1` (or
`traced_steps + 1`), which the traced run adds after the window. Every
span and counter inside [the first one's start, the last one's end], on
any thread, is the window's. Where the program has no such recorder (a
checkout from before it), or the spans found do not add up to the run's
counts, `slam` and `train` return None and the readers report nothing.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

# The tracking path's enqueue stages of a frame, each a span on the main thread.
STAGES = ("encode", "decode", "match_track")


class Window(NamedTuple):
    top: list  # the window's `frame` or `train_step` spans, in order
    spans: list  # every span inside the window, any thread
    counts: list  # every counter event inside it
    main: int  # the main thread's native id, as the recorder names threads


def store():
    """The program's recorder, or None where the program has none."""
    try:
        from monst3r_slam_torch.utils import timing
    except ImportError:
        return None
    if not (callable(getattr(timing, "spans", None)) and callable(getattr(timing, "counts",
                                                                          None))):
        return None
    return timing


def window(run: dict, top: str, n_key: str, traced_key: str, rec=None) -> Optional[Window]:
    rec = store() if rec is None else rec
    n, traced = run.get(n_key), run.get(traced_key)
    if rec is None or not n or traced is None:
        return None
    main = threading.main_thread().native_id
    rows = rec.spans()
    tops = sorted((s for s in rows if s.name == top and s.tid == main and s.parent is None),
                  key=lambda s: s.t0)
    if len(tops) < n + traced + 1:
        return None
    chosen = tops[len(tops) - traced - 1 - n:len(tops) - traced - 1]
    lo, hi = chosen[0].t0, chosen[-1].t1
    return Window(chosen, [s for s in rows if s.t0 >= lo and s.t1 <= hi],
                  [c for c in rec.counts() if lo <= c.t <= hi], main)


def slam(run: dict, rec=None) -> Optional[Window]:
    """The SLAM window: its `frames` frames (`harness/slam_oracle.py`)."""
    return window(run, "frame", "frames", "traced_frames", rec)


def train(run: dict, rec=None) -> Optional[Window]:
    """The training window: its `steps` steps (`harness/train_pairs.py`)."""
    return window(run, "train_step", "steps", "traced_steps", rec)


def main_thread(w: Window, name: str) -> list:
    return [s for s in w.spans if s.tid == w.main and s.name == name]


def tracked_frames(w: Window) -> int:
    """Frames that went through the tracker: one `match_track` each."""
    return len(main_thread(w, "match_track"))


def wait_ns_under(w: Window, names) -> dict:
    """sid -> ns of the `wait` spans below each span named in `names`,
    counted in the nearest such span above them."""
    by_sid = {s.sid: s for s in w.spans}
    out: dict = {}
    for s in w.spans:
        if s.name != "wait":
            continue
        p = by_sid.get(s.parent)
        while p is not None and p.name not in names:
            p = by_sid.get(p.parent)
        if p is not None:
            out[p.sid] = out.get(p.sid, 0) + (s.t1 - s.t0)
    return out


def device_ms(w: Window, name: str) -> list:
    """The device ms of the window's spans `name` that have one."""
    return [s.device_ms for s in w.spans if s.name == name and s.device_ms is not None]
