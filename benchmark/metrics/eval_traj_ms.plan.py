"""A back-end cost evaluation's host time in the trajectory (MINCO's
solve, the energy and the time cost): the mean of the program's
``eval.traj`` spans over the profiled plans, in ms."""

from benchmark.metrics import _spans


def read(rec):
    return _spans.mean_ms(rec, "plan", "eval.traj")
