"""The import guard: a run of each cell loads no module whose top-level
name is jax, jaxlib, flax or isdf_tpu (compared whole: isdf_torch shares
isdf_tpu's first letters), and the reference loads nothing of the
program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from tests_paths import CELLS, ROOT

BANNED = {"jax", "jaxlib", "flax", "isdf_tpu"}

RUN = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark.harness import core
rc = core.main({argv!r}, t0, Path({root!r}), device="cpu", hook={hook!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_no_jax(cell, small):
    argv = ["--workload", cell, "--seed", "2147483659", "--seconds", "0.1",
            "--trace", "0"]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(ROOT), argv=argv,
                                          hook=small)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result, modules = json.loads(lines[-2]), set(json.loads(lines[-1]))
    assert result["checks"]
    assert "isdf_torch" in modules
    assert not modules & BANNED, modules & BANNED


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("part", ["reference", "frozen"])
def test_reference_imports_nothing_of_the_program(part):
    for path in sorted((ROOT / "benchmark" / part).glob("*.py")):
        names = set(_imports(path))
        assert not names & (BANNED | {"isdf_torch"}), (path, names)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import benchmark.{part}; "
            + ("import benchmark.reference.judge; " if part == "reference"
               else "import benchmark.frozen.flops; ")
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isdf_torch" not in out.stdout and "jax" not in out.stdout
