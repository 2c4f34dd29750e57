"""The front end (SE(3) A* over the pose-feasibility volume: search/astar.py,
native.py): mean ms a plan, from each plan's own phase times."""

from benchmark.harness import readers


def read(rec):
    return readers.per_plan_ms(rec, "front_end_s")
