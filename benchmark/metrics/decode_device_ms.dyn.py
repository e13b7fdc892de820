"""decode_device_ms.dyn: the median over the traced frames of the device's
busy ms of a tracked frame's two decodes: the operations that its
`decode_monst3r` and `decode_mast3r` spans (the children of one `decode`
span) launched, each the union of their intervals on the device, summed
(`harness/trace_spans.py`). None without a trace, or where the program
records no such spans."""

import numpy as np

from benchmark.harness import trace_spans


def read(run):
    per_frame: dict = {}
    for name in ("decode_monst3r", "decode_mast3r"):
        for s, ms in trace_spans.span_busy_ms(run, name):
            per_frame.setdefault(s.parent, []).append(ms)
    both = [sum(v) for v in per_frame.values() if len(v) == 2]
    return float(np.median(both)) if both else None
