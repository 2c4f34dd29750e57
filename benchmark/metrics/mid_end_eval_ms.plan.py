"""A mid-end cost evaluation's host time: the mean of the program's
``mid_end.eval`` spans over the profiled plans, in ms."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.mean_ms(rec, "plan", "mid_end.eval")
