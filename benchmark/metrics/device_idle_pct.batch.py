"""The card's idle share of the profiled solve, in %."""

from benchmark.harness import readers


def read(rec):
    return readers.idle_pct(rec)
