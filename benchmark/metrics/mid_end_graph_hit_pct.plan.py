"""The share of the mid end's cost evaluations that replayed their CUDA
graph: the program's ``mid_end.eval`` spans whose ``graph`` attribute is
``replay``, over all of them in the profiled plans, in %.  A program whose
spans carry no ``graph`` attribute gives None."""

from benchmark.metrics import _spans


def read(rec):
    got = _spans.window(rec, "plan")
    if got is None:
        return None
    evals = [s for s in got[1] if s.name == "mid_end.eval"]
    modes = [s.attrs["graph"] for s in evals if "graph" in s.attrs]
    if not modes or len(modes) != len(evals):
        return None
    return 100.0 * modes.count("replay") / len(modes)
