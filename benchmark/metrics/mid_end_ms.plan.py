"""The mid end (opt/midend.py, L-BFGS on the waypoint fit): mean ms a plan."""

from benchmark.harness import readers


def read(rec):
    return readers.per_plan_ms(rec, "mid_end_s")
