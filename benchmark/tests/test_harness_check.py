"""The check that decides ``correct``, rehearsed on the CPU through the
test hook: the port's answers pass it, the control's (the reference in
bfloat16 in the program's place) fail it, and a run whose timed path is
broken underneath (``benchmark/harness/faults.py``) comes out not
correct."""

import importlib

import pytest
import torch

from benchmark.harness import core, faults
from tests_paths import CELLS, ROOT


def _ctx(cell, hook, seed=7):
    ctx = core.load_context(ROOT, cell, seed, 0.1, False, hook)
    ctx.device = torch.device("cpu")
    return ctx, importlib.import_module(
        f"benchmark.harness.drivers.{ctx.traffic['driver']}")


@pytest.mark.parametrize("cell", CELLS)
def test_port_passes_and_control_fails(cell, small):
    ctx, driver = _ctx(cell, small)
    r = core.control_readings(ctx, driver)
    assert r["failed"] == 0
    assert core.within(r["program"], ctx.limits), r["program"]
    assert not core.within(r["control"], ctx.limits), r["control"]


def _cases():
    for cell in CELLS:
        ctx = core.load_context(ROOT, cell, 0, 0.1, False)
        for fault in faults.FOR[ctx.traffic["driver"]]:
            if fault not in faults.CELL_SIZE_ONLY:
                yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_broken_path_is_not_correct(cell, fault, small):
    ctx, driver = _ctx(cell, small)
    with faults.plant(fault, ctx.traffic["driver"]):
        r = core.control_readings(ctx, driver, control=False)
    assert not core.within(r["program"], ctx.limits), r["program"]
