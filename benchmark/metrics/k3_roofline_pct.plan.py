"""K3 (sweep/grid_zoom.py, csrc/grid_sweep.cu) in the profiled plans: its
bound over its device time, in %."""

from benchmark.harness import readers


def read(rec):
    return readers.roofline_pct(rec, ("k3",), "grid_sweep_kernel")
