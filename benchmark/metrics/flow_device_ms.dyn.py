"""flow_device_ms.dyn: the median over the traced frames' `flow_program`
spans (RAFT's 20 iterations, the ego-motion flow and the error map,
enqueued before the MASt3R decode) of the device's busy ms of the
operations each launched, the union of their intervals
(`harness/trace_spans.py`). None without a trace, or where the program
records no such span."""

import numpy as np

from benchmark.harness import trace_spans


def read(run):
    ms = [v for _, v in trace_spans.span_busy_ms(run, "flow_program")]
    return float(np.median(ms)) if ms else None
