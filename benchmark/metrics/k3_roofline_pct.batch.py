"""K3 batched (csrc/grid_sweep.cu) in the profiled solve: its bound over its
device time, in %."""

from benchmark.harness import readers


def read(rec):
    return readers.roofline_pct(rec, ("k3b",), "grid_sweep_kernel")
