"""The back end (opt/backend.py, opt/lbfgs.py; its safety re-solves
included): mean ms a plan."""

from benchmark.harness import readers


def read(rec):
    return readers.per_plan_ms(rec, "back_end_s")
