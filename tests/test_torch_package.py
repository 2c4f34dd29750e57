"""Rules of the port that no parity test sees: isdf_torch (and the on-card
smoke script) import neither JAX nor isdf_tpu, and an entry point asked for
the default device never runs quietly on the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from isdf_torch.config import Config
from isdf_torch.opt import backend
from isdf_torch.plan import PlannerManager

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "isdf_tpu")


def test_import_leaves_jax_and_isdf_tpu_unloaded():
    code = (
        "import sys, torch\n"
        "import isdf_torch\n"
        "from isdf_torch.config import Config\n"
        "from isdf_torch.plan import PlannerManager\n"
        "from isdf_torch.sweep import fused_zoom\n"
        "from isdf_torch.plan import planar, closed_loop, traj_server\n"
        "from isdf_torch.world import moving, pcd\n"
        "from isdf_torch import demos\n"
        "from isdf_torch.opt import checkpoint, lmbm\n"
        "from isdf_torch.utils import monitor, flops\n"
        "from isdf_torch import cli, native, sim\n"
        "from isdf_torch.viz import swept_mesh, export, html_view, live_view\n"
        "from isdf_torch.plan import goals\n"
        "from isdf_torch.parallel import mesh, dryrun\n"
        "from isdf_torch import bench\n"
        "pm = PlannerManager(Config(), shape_name='Ball', device='cpu')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'isdf_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_forbidden_import_in_source():
    files = sorted((ROOT / "isdf_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, f"{f}: imports {mod}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlannerManager(Config(), shape_name="Ball")
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.optimize(None, Config(), [[0.0] * 3] * 3, [[0.0] * 3] * 3,
                         [[1.0, 0.0, 0.0]], [1.0, 1.0], [[5.0] * 3], [True])
    pm = PlannerManager(Config(), shape_name="Ball", device="cpu")
    assert pm.device.type == "cpu"
