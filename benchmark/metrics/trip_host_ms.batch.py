"""The host's time to enqueue one loop trip of the batched lockstep solve
(two cost evaluations and the solver's step): the mean of the program's
``lockstep.trip`` spans over the profiled solves, in ms."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.mean_ms(rec, "batch.solve", "lockstep.trip")
