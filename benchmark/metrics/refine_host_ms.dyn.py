"""refine_host_ms.dyn: the median host ms of the window's `mask_refine`
spans less their `sam2` children: the mask's host work after the MASt3R
decode is enqueued (the propagator's RAFT flow from the previous masked
frame and its read-back, the warp, the connected components, SAM2's input
resize, the masks' merge), SAM2's own encode, decode and read-back left
out (the port's recorder, `harness/spans.py`). None where the program
records no `sam2` span."""

import numpy as np

from benchmark.harness import spans


def read(run):
    w = spans.slam(run)
    if w is None:
        return None
    sam2 = [s for s in w.spans if s.name == "sam2"]
    if not sam2:
        return None
    child: dict = {}
    for s in sam2:
        child[s.parent] = child.get(s.parent, 0) + (s.t1 - s.t0)
    ms = [((s.t1 - s.t0) - child.get(s.sid, 0)) / 1e6 for s in w.spans if s.name == "mask_refine"]
    return float(np.median(ms)) if ms else None
