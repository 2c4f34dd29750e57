"""A back-end cost evaluation's host time in the swept-volume penalty (the
sweep kernel's launch and the re-evaluation at t*): the mean of the
program's ``eval.sweep`` spans over the profiled plans, in ms."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.mean_ms(rec, "plan", "eval.sweep")
