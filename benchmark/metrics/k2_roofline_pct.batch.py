"""K2 (the batched launch of csrc/sweep_warm.cu) in the profiled solve: its
bound over its device time, in %."""

from benchmark.harness import readers


def read(rec):
    return readers.roofline_pct(rec, ("k2",), "sweep_warm_kernel")
