"""The repository's root and the benchmark's cells, for the tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
