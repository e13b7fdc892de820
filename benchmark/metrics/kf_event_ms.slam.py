"""kf_event_ms.slam: the median keyframe event of the window on the main
thread, host ms: the `kf_event` span (keyframe append, the backend job's
hand-off to the worker; the port's recorder, `harness/spans.py`). None
where the program records no spans or the window holds no event."""

import numpy as np

from benchmark.harness import spans


def read(run):
    w = spans.slam(run)
    ev = [] if w is None else spans.main_thread(w, "kf_event")
    return float(np.median([(s.t1 - s.t0) / 1e6 for s in ev])) if ev else None
