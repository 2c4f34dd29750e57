"""A configuration, a traffic mix and a per-layer metric added as files and
entries alone, in a directory of their own, are run by name: no file of
benchmark/ is edited."""

import json
import shutil
import time

from benchmark.harness import core
from tests_paths import ROOT


def test_new_config_mix_and_metric_run_by_name(tmp_path, small, capsys):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/demo1_roundedcone.json")
                     .read_text())
    cfg["name"] = "demo1_slow"
    cfg["settings"]["rho"] = 40.0
    for d in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / "benchmark" / d).mkdir(parents=True)
    (tmp_path / "benchmark/configs/demo1_slow.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark/traffic/batch2.json").write_text(json.dumps(
        {"driver": "batch_solve", "B": 2, "N": 4, "P": 16, "max_iters": 8,
         "chunk": 8, "pool": 1, "check": 2}))
    (tmp_path / "benchmark/metrics/solves_seen.batch.py").write_text(
        "def read(rec):\n    return len(rec['solves'])\n")
    shutil.copy(ROOT / "benchmark/limits/demo1.batch4096.json",
                tmp_path / "benchmark/limits/demo1_slow.batch2.json")
    spec["configs"] = [dict(spec["configs"][0], name="demo1_slow",
                            file="benchmark/configs/demo1_slow.json")]
    spec["workloads"] = [dict(name="demo1_slow.batch2", config="demo1_slow",
                              traffic="batch2", chips=1, why="a test")]
    spec["end_to_end"] = [dict(m, workloads=["demo1_slow.batch2"])
                          if "workloads" in m else m
                          for m in spec["end_to_end"] if m["name"] in
                          ("setup_s", "plans_per_s")]
    spec["per_layer"] = [dict(name="solves_seen.batch", unit="solves",
                              better="higher", source="program_counter",
                              layer="batched path", moves="plans_per_s")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    hook = {"settings": small["settings"], "limits": small["limits"]}
    rc = core.main(["--workload", "demo1_slow.batch2", "--seed", "1",
                    "--seconds", "0.1", "--trace", "1"], time.perf_counter(),
                   tmp_path, device="cpu", hook=hook)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["attempted"] == 2 and result["correct"] is True
    assert result["metrics"]["solves_seen.batch"]["value"] >= 1
    assert list(result)[-1] == "checks"
