"""opt_device_ms.train: the median device ms of the training step's
`optimizer` phase in the window: the time on the stream between the CUDA
events at the two ends of each step's `optimizer` span (the port's recorder,
`harness/spans.py`). None where the program records no device spans."""

import numpy as np

from benchmark.harness import spans


def read(run):
    w = spans.train(run)
    ms = [] if w is None else spans.device_ms(w, "optimizer")
    return float(np.median(ms)) if ms else None
