"""Device values read on the host a batched solve: the count the program's
``batch.solve`` spans carry, over the profiled solves."""

from benchmark.metrics import _spans


def read(rec):
    got = _spans.window(rec, "batch.solve")
    if got is None:
        return None
    roots = got[0]
    if any("host_reads" not in s.attrs for s in roots):
        return None
    return sum(s.attrs["host_reads"] for s in roots) / len(roots)
