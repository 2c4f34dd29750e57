"""The share of the batched solve's cost evaluations whose trajectory state
at the sweep's t* ran the hand-written piece kernel: the program's
``back_end.eval`` spans whose ``pieces`` attribute is ``kernel``, over all
of them in the profiled solves, in %.  A program whose spans carry no
``pieces`` attribute gives None."""

from benchmark.metrics import _spans


def read(rec):
    got = _spans.window(rec, "batch.solve")
    if got is None:
        return None
    evals = [s for s in got[1] if s.name == "back_end.eval"]
    ran = [s.attrs["pieces"] for s in evals if "pieces" in s.attrs]
    if not ran or len(ran) != len(evals):
        return None
    return 100.0 * ran.count("kernel") / len(ran)
