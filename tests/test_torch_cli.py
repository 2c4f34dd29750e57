"""The port's command-line runner on the CPU (``python -m isdf_torch.cli
... --device cpu``), driven as a user drives it, in a subprocess: demo 6
(the mesh robot; its Lthick.obj is the synthetic L written into a stand-in
reference checkout at $ISDF_REFERENCE_ROOT) with every artifact flag, and
the closed-loop flight.  Each must write the files the JAX package's cli
writes for the same flags (isdf_tpu/cli.py:20-90, 98-149)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from isdf_torch import cli
from isdf_torch.shapes import mesh

ROOT = Path(__file__).resolve().parents[1]


def _run(args, env_extra=None, timeout=300):
    # one CPU thread: these runs are small and take no longer on one
    # (measured), and the suite runs beside them in other processes
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    proc = subprocess.run([sys.executable, "-m", "isdf_torch.cli", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_demo6_writes_every_artifact(tmp_path):
    ref = tmp_path / "reference"
    shapes = ref / "src" / "plan_manager" / "shapes"
    shapes.mkdir(parents=True)
    mesh.write_obj(str(shapes / "Lthick.obj"), *mesh.l_prism())
    out = tmp_path / "out"
    _run(["demo", "6", "--fast", "--iters", "3", "--swept-mesh",
          "--mesh-res", "0.5", "--view", "--monitor", "--device", "cpu",
          "--out", str(out)], {"ISDF_REFERENCE_ROOT": str(ref)})

    want = {"metrics.json", "trajectory.csv", "astar_path.csv",
            "swept_volume.obj", "scene.html", "replay.csv",
            "pose_kernel.obj"}
    if _has_matplotlib():
        want.add("cost_curve.png")
    assert want <= {p.name for p in out.iterdir()}

    m = json.loads((out / "metrics.json").read_text())
    assert m["success"] is True and m["min_swept_sdf"] > 0
    assert m["monitor"]["samples"] >= 1
    V, F = mesh.load_obj(str(out / "swept_volume.obj"))
    T = m["swept_mesh_tris"]
    assert T > 0 and len(F) == T and len(V) == 3 * T
    traj = np.loadtxt(out / "trajectory.csv", delimiter=",", skiprows=1)
    assert traj.shape == (500, 7) and np.isfinite(traj).all()
    path = np.loadtxt(out / "astar_path.csv", delimiter=",")
    assert path.ndim == 2 and path.shape[1] == 3
    replay = np.loadtxt(out / "replay.csv", delimiter=",", skiprows=1)
    assert replay.shape[1] == 8
    html = (out / "scene.html").read_text()
    data = json.loads(re.search(r"const DATA = (\{.*?\});\n", html,
                                re.S).group(1))
    assert [L["name"] for L in data["layers"]] == [
        "map voxels", "A* path", "trajectory", "poses", "swept volume"]
    assert len(data["layers"][-1]["tris"]) == T
    assert m["view_html"] == str(out / "scene.html")


def test_closed_loop_writes_flight_and_metrics(tmp_path):
    out = tmp_path / "cl"
    _run(["closed-loop", "--max-time", "3", "--iters", "2", "--device",
          "cpu", "--out", str(out)])
    m = json.loads((out / "metrics.json").read_text())
    assert set(m) == {"reached", "ticks", "min_body_sdf", "replans",
                      "replan_p50_s", "wall_s"}
    assert m["replans"] == 2 and m["ticks"] == 300
    flight = np.loadtxt(out / "flight.csv", delimiter=",")
    assert flight.shape == (300, 4) and np.isfinite(flight).all()


def test_default_device_is_the_card(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["closed-loop", "--out", str(tmp_path / "cl")])
    with pytest.raises(SystemExit):
        cli.main(["bench"])          # no bench subcommand in the port yet
