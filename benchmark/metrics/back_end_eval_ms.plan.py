"""The back end's host and device time a cost evaluation: its seconds over
its evaluations, summed over the window's plans, in ms."""


def read(rec):
    plans = rec.get("plans", [])
    evals = sum(p["back_end_evals"] for p in plans)
    if not evals:
        return None
    return 1e3 * sum(p["back_end_s"] for p in plans) / evals
