"""A back-end cost evaluation's host time in the gradient (autograd's
backward pass): the mean of the program's ``eval.backward`` spans over the
profiled plans, in ms."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.mean_ms(rec, "plan", "eval.backward")
