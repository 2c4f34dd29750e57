"""The per-layer metrics that read the program's own spans
(``benchmark/metrics/_spans.py``), rehearsed on the CPU: each cell run with
``--trace 1`` at the tests' tiny sizes, as test_harness_data_driven.py
runs one; each such metric reads a finite number in the cells its entry
names and nothing in the others, and a program without the span recorder
gives none."""

import importlib
import json
import math
import time

import pytest

from benchmark.harness import core
from tests_paths import CELLS, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in SPEC["per_layer"]
                if "_spans" in (ROOT / "benchmark" / "metrics"
                                / f"{m['name']}.py").read_text()}


def _reader(name):
    return core._load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("cell", CELLS)
def test_span_metrics_read_in_their_cells(cell, small, capsys, monkeypatch):
    assert len(SPAN_METRICS) == 10
    traffic = json.loads((ROOT / "benchmark" / "traffic" / (
        {w["name"]: w for w in SPEC["workloads"]}[cell]["traffic"]
        + ".json")).read_text())
    driver = importlib.import_module(
        f"benchmark.harness.drivers.{traffic['driver']}")
    seen = {}
    window = driver.window

    def keep(ctx, st):
        seen["win"] = window(ctx, st)
        return seen["win"]
    monkeypatch.setattr(driver, "window", keep)
    hook = {k: small[k] for k in ("settings", "traffic", "limits")}
    rc = core.main(["--workload", cell, "--seed", "3000000001", "--seconds",
                    "0.1", "--trace", "1"], time.perf_counter(), ROOT,
                   device="cpu", hook=hook)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = seen["win"]["records"]
    for name, entry in SPAN_METRICS.items():
        v = _reader(name)(rec)
        if cell in entry["workloads"]:
            assert v is not None and math.isfinite(v), (name, v)
            assert line["metrics"][name]["value"] == pytest.approx(v)
        else:
            assert v is None, (name, v)
            assert name not in line["metrics"]
    # a program without the recorder: every span metric reads nothing
    from isdf_torch.utils import obs
    monkeypatch.delattr(obs, "spans")
    for name in SPAN_METRICS:
        assert _reader(name)(rec) is None, name
