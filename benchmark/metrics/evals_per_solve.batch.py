"""Cost evaluations a batched solve (parallel/batch.py, opt/lbfgs.py
minimize_lockstep): the sweep kernel's launches a solve, one an
evaluation, read from the program's launch counters."""


def read(rec):
    solves = rec.get("solves", [])
    if not solves or not any(s["launches"] for s in solves):
        return None
    return sum(s["launches"] for s in solves) / len(solves)
