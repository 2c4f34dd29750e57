"""A back-end cost evaluation's host time in the dynamic-feasibility and
attitude penalties: the mean of the program's ``eval.dyn`` spans over the
profiled plans, in ms."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.mean_ms(rec, "plan", "eval.dyn")
