"""On the card, at each cell's own size, one seed: the port's answers pass
the check and the bfloat16 control's fail it; and each fault that shows
only at the cell's size (``faults.CELL_SIZE_ONLY``) and that the cell's
limits file lists under ``card_faults`` comes out not correct.  Skips
without a card: ``python -m pytest benchmark/tests -m cuda`` on the H100."""

import json
import subprocess
import sys

import pytest

from tests_paths import CELLS, ROOT


def _limits(cell):
    return json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json")
                      .read_text())


def _control(cell, *extra):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = "30" if cell.endswith(".plan") else "0.1"
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "control.py"),
         "--workload", cell, "--seeds", "2147483999", "--seconds", seconds,
         *extra], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(cell):
    r = _control(cell)
    limits = _limits(cell)["limits"]
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in _limits(c).get("card_faults", [])])
def test_fault_on_card(cell, fault):
    r = _control(cell, "--fault", fault)
    limits = _limits(cell)["limits"]
    assert any(r["program"][k] > v for k, v in limits.items()), r
