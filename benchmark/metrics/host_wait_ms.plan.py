"""The time a plan's L-BFGS solves wait on the host for device values: the
program's ``host_read`` spans within its ``plan.mid_end`` and
``plan.back_end`` spans, summed, over the profiled plans, in ms a plan."""

from benchmark.metrics import _spans


def read(rec):
    got = _spans.window(rec, "plan")
    if got is None:
        return None
    roots, spans = got
    reads = _spans.within(spans, "host_read",
                          ("plan.mid_end", "plan.back_end"))
    return sum(_spans.ms(s) for s in reads) / len(roots)
