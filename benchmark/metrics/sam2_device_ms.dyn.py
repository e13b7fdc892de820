"""sam2_device_ms.dyn: the median over the traced frames' `sam2` spans, one
a call of SAM2's refiner (the Hiera-B+ encode, the prompt decode and the
selection), of the device's busy ms of the operations each launched, the
union of their intervals (`harness/trace_spans.py`). None without a trace,
or where the program records no such span."""

import numpy as np

from benchmark.harness import trace_spans


def read(run):
    ms = [v for _, v in trace_spans.span_busy_ms(run, "sam2")]
    return float(np.median(ms)) if ms else None
