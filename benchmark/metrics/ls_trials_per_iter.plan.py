"""Line-search trials a back-end iteration: the trials over the iterations
that the program's ``plan.back_end`` spans count, over the profiled plans
(1 where every first trial is accepted)."""

from benchmark.metrics import _spans


def read(rec):
    got = _spans.window(rec, "plan")
    if got is None:
        return None
    solves = [s for s in got[1] if s.name == "plan.back_end"]
    iters = sum(s.attrs.get("iterations", 0) for s in solves)
    if not iters:
        return None
    return sum(s.attrs.get("trials", 0) for s in solves) / iters
