"""The plan manager's swept-SDF audit (plan/manager.py): mean ms a plan."""

from benchmark.harness import readers


def read(rec):
    return readers.per_plan_ms(rec, "audit_s")
