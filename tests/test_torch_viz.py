"""isdf_torch's viz (swept-volume mesh, exports, HTML scene) against
isdf_tpu's on the CPU, float64, the same inputs through both packages.

Held here:
  * sdf_volume (the cold sweep over a dense grid, one chunk of ≤ 4,096
    voxels) for Ball and RoundedCone posed, in the cold-sweep band of
    tests/test_torch_sweep.py: SDF atol 2e-4 / rtol 1e-4.  On the CPU JAX's
    cold sweep runs one zoom from the coarse argmin; the port's (the TPU
    dispatch, K1's plain version here) adds a zoom from t = 0 and keeps the
    deeper branch, so the port's value is never above JAX's beyond the band
    (and on this grid it equals JAX's within the band everywhere);
  * marching tetrahedra: JAX's field through the port's C++ core gives
    JAX's triangles in the same order.  JAX's library is built by make with
    -march=native, which lets g++ contract a + t·(b − a) into one fused
    multiply-add; the port builds without it.  So the vertices agree to
    1e-12, not bit for bit (measured: 4.4e-16).  The port's Python twin
    equals its C++ core exactly;
  * export_obj byte for byte (the header comment names the package);
    export_traj_csv parsed within 1e-5 (the files' last printed digit);
    sdf_time_curve within 1e-10;
  * HtmlScene and export_plan_view: the embedded JSON (numbers rounded to
    4 decimals by both) equal within 2e-4.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu import native as jnative
from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import minco as jminco
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.viz import export as jexport
from isdf_tpu.viz import html_view as jhtml
from isdf_tpu.viz import swept_mesh as jswept

from isdf_torch import native
from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.shapes import make_shape
from isdf_torch.viz import export, html_view, swept_mesh

F64 = torch.float64
D_ATOL, D_RTOL = 2e-4, 1e-4
RES = 0.3
ORIGIN = np.array([-1.0, -2.0, -2.1])
SIZE = (16, 16, 16)                 # 4,096 voxels: one chunk
POSES = {"Ball": None, "RoundedCone": (0.0, 0.0, 0.0, 120.0, 0.0, 0.0)}


def _case(name):
    """A 3-piece trajectory through both packages, float64."""
    kw = {} if POSES[name] is None else dict(poly_params=POSES[name])
    q = np.array([[0.8, 0.3, 0.2], [1.6, 0.5, 0.1]])
    T = np.array([0.8, 0.9, 0.8])
    tail = np.zeros((3, 3))
    tail[:, 0] = [2.4, 0.4, 0.3]
    j = lambda a: jnp.asarray(a, jnp.float64)    # noqa: E731
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    jtraj = JPolyTraj(j(T), jminco.solve(j(q), j(T), jnp.zeros((3, 3)),
                                         j(tail)))
    ttraj = PolyTraj(t(T), minco.solve(t(q), t(T), torch.zeros(3, 3,
                                       dtype=F64), t(tail)))
    jc, tc = JConfig(**kw), Config(**kw)
    return dict(j=(jmake_shape(name, jc), jtraj,
                   jfl.FlatParams.from_config(jc)),
                t=(make_shape(name, tc), ttraj, fl.FlatParams.from_config(tc)))


@pytest.fixture(scope="module")
def volumes():
    """{name: (case, JAX field, port field)} on the same 16³ grid."""
    out = {}
    for name in POSES:
        c = _case(name)
        fj = jswept.sdf_volume(*c["j"], ORIGIN, SIZE, RES)
        ft = swept_mesh.sdf_volume(*c["t"], ORIGIN, SIZE, RES, device="cpu")
        out[name] = (c, np.asarray(fj), ft)
    return out


@pytest.mark.parametrize("name", sorted(POSES))
def test_sdf_volume_matches_jax(volumes, name):
    _, fj, ft = volumes[name]
    assert ft.shape == SIZE and ft.dtype == np.float64
    assert np.isfinite(ft).all()
    assert (ft < 0).any() and (ft > 0).any()
    band = D_ATOL + D_RTOL * np.abs(fj)
    assert np.all(ft <= fj + band)
    # on this grid every voxel lands in the band (measured: 1.2e-5 at most)
    assert np.all(np.abs(ft - fj) <= band)


@pytest.mark.parametrize("name", sorted(POSES))
def test_auto_bounds_match_jax(name):
    c = _case(name)
    oj, sj = jswept._auto_bounds(c["j"][1], c["j"][0], 0.25)
    ot, st = swept_mesh._auto_bounds(c["t"][1], c["t"][0], 0.25)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-12)
    assert st == sj


@pytest.mark.parametrize("name", sorted(POSES))
def test_marching_tetrahedra_on_jax_field(volumes, name):
    if jnative.get_lib() is None or native.get_lib() is None:
        pytest.skip("no C++ compiler for the native cores")
    _, fj, _ = volumes[name]
    want = jnative.marching_tetrahedra(fj, ORIGIN, RES, 0.0)
    got = native.marching_tetrahedra(fj, ORIGIN, RES, 0.0)
    assert len(got) == len(want) > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_python_twin_equals_cpp_core():
    if native.get_lib() is None:
        pytest.skip("no C++ compiler for the native core")
    n, res = 12, 0.41
    origin = np.array([-2.5, -2.3, -2.1])
    xs = origin[0] + np.arange(n) * res
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    rng = np.random.default_rng(0)
    field = (np.linalg.norm(g, axis=-1) - 1.5
             + 0.1 * rng.normal(size=g.shape[:3]))
    a = native.marching_tetrahedra(field, origin, res, 0.0)
    b = swept_mesh._marching_tetrahedra_py(field, origin, res, 0.0)
    assert len(a) > 100
    np.testing.assert_array_equal(a, b)


def test_swept_volume_mesh_is_a_tube(tmp_path):
    """JAX's own check (tests/test_native_viz.py): a ball swept along a
    straight line gives a capsule, through the C++ core."""
    q = torch.tensor([[2.0, 0.0, 0.0]], dtype=F64)
    T = torch.tensor([2.0, 2.0], dtype=F64)
    tail = torch.zeros(3, 3, dtype=F64)
    tail[:, 0] = torch.tensor([4.0, 0.0, 0.0], dtype=F64)
    traj = PolyTraj(T, minco.solve(q, T, torch.zeros(3, 3, dtype=F64), tail))
    swept_mesh.PY_TWIN_CALLS = 0
    tris = swept_mesh.swept_volume_mesh(make_shape("Ball"), traj,
                                        fl.FlatParams(), resolution=0.3,
                                        device="cpu")
    assert swept_mesh.PY_TWIN_CALLS == (0 if native.get_lib() else 1)
    v = tris.reshape(-1, 3)
    t = np.clip(v[:, 0], 0.0, 4.0)
    d = np.linalg.norm(v - np.stack([t, 0 * t, 0 * t], -1), axis=1)
    assert len(tris) > 50 and np.percentile(np.abs(d - 1.0), 95) < 0.35


def test_export_obj_byte_equal(tmp_path):
    tris = np.random.default_rng(1).uniform(-3, 3, size=(40, 3, 3))
    jexport.export_obj(str(tmp_path / "j.obj"), tris)
    export.export_obj(str(tmp_path / "t.obj"), tris)
    want = (tmp_path / "j.obj").read_bytes()
    got = (tmp_path / "t.obj").read_bytes()
    assert got == want.replace(b"# isdf_tpu export", b"# isdf_torch export")


def test_export_traj_csv_matches_jax(tmp_path):
    c = _case("RoundedCone")
    jexport.export_traj_csv(str(tmp_path / "j.csv"), c["j"][1])
    export.export_traj_csv(str(tmp_path / "t.csv"), c["t"][1])
    lines = (tmp_path / "t.csv").read_text().splitlines()
    assert lines[0] == (tmp_path / "j.csv").read_text().splitlines()[0]
    a = np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)
    assert a.shape == b.shape == (500, 7)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 + 1e-12)


@pytest.mark.parametrize("name", sorted(POSES))
def test_sdf_time_curve_matches_jax(name, tmp_path):
    c = _case(name)
    point = np.array([1.1, 0.9, 0.4])
    tj, dj = jexport.sdf_time_curve(*c["j"], point)
    tt, dt = export.sdf_time_curve(*c["t"], point)
    assert dt.shape == (512,)
    np.testing.assert_allclose(tt, np.asarray(tj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(dt, np.asarray(dj), rtol=0, atol=1e-10)
    export.export_sdf_curve_csv(str(tmp_path / "c.csv"), *c["t"], point)
    rows = np.loadtxt(tmp_path / "c.csv", delimiter=",", skiprows=1)
    np.testing.assert_allclose(rows[:, 1], dt, atol=1e-6)


def _data(path):
    html = open(path).read()
    assert "<script src" not in html
    return json.loads(re.search(r"const DATA = (\{.*?\});\n", html,
                                re.S).group(1))


def _assert_same(a, b, where=""):
    """Nested JSON equal: strings and structure exactly, numbers within
    2e-4 (both sides round to 4 decimals)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert abs(a - b) <= 2e-4, (where, a, b)
    else:
        assert a == b, where


def test_html_scene_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 5, (200, 3))
    line = np.linspace(0, 5, 30)[:, None] * np.ones(3)
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
    F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    Rs = np.stack([np.eye(3), np.eye(3)[[1, 2, 0]]])
    for mod, name in ((jhtml, "j"), (html_view, "t")):
        sc = mod.HtmlScene("scene")
        sc.add_points("voxels", pts)
        sc.add_line("traj", line)
        sc.add_mesh("body", V, F)
        sc.add_poses("poses", np.array([[1.0, 2.0, 0.5], [2.0, 1.0, 0.5]]), Rs)
        sc.write(str(tmp_path / f"{name}.html"))
    _assert_same(_data(tmp_path / "j.html"), _data(tmp_path / "t.html"))
    assert "isdf_torch scene" in html_view.HtmlScene().title


def test_export_plan_view_matches_jax(tmp_path):
    """The trajectory-only scene of tests/test_native_viz.py, with the pose
    triads (traj_states under the posed RoundedCone)."""
    c = _case("RoundedCone")
    jhtml.export_plan_view(str(tmp_path / "j.html"), traj=c["j"][1],
                           params=c["j"][2])
    out = html_view.export_plan_view(str(tmp_path / "t.html"),
                                     traj=c["t"][1], params=c["t"][2])
    data = _data(out)
    assert [L["name"] for L in data["layers"]] == ["trajectory", "poses"]
    _assert_same(_data(tmp_path / "j.html"), data)
    assert "<title>isdf_torch plan</title>" in open(out).read()
