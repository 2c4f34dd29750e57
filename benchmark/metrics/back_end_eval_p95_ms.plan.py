"""The 95th percentile of a back-end cost evaluation's host time over the
profiled plans (the program's ``back_end.eval`` spans), in ms."""

import numpy as np

from benchmark.metrics import _spans


def read(rec):
    d = _spans.durations(rec, "plan", "back_end.eval")
    return None if d is None else float(np.percentile(d, 95))
