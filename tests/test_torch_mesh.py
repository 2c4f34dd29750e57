"""isdf_torch's mesh robots against isdf_tpu on the CPU: the OBJ loader and
the mesh SDF bake, the front end of the L robot on demo 6's map, and a short
mesh plan of the port.

The robot is the thick L of ``shapes/mesh.l_prism`` (arms 1.6 m and 1.0 m,
0.3 m thick), written as an OBJ file and loaded back, as ``chip_smoke.py``
does; the cube is tests/test_mesh.py's.  Bakes run in float64 on both sides
(the JAX tests run under x64)."""

import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.search import astar as jastar
from isdf_tpu.search import pose_kernels as jpk
from isdf_tpu.shapes import gridsdf as jgridsdf
from isdf_tpu.shapes import mesh as jmesh
from isdf_tpu.world import GridMap as JGridMap

from isdf_torch.config import Config
from isdf_torch.plan import PlannerManager
from isdf_torch.search import astar, pose_kernels
from isdf_torch.shapes import mesh as meshlib
from isdf_torch.shapes import shape_from_config
from isdf_torch.sweep import grid_zoom
from isdf_torch.world import GridMap, maps_gen

F64 = torch.float64
SURFACE = 1e-6      # distances this close to 0 may flip sign between bakes
POSE = (0.1, -0.2, 0.05, 30.0, 10.0, -20.0)
# demo 6's front end (isdf_tpu/demos.py:139-149), its pose grid coarsened to
# 22.5° and its map cropped to the first slit wall
FRONT = dict(selfmapresu=0.1, occupancy_resolution=1.0, kernel_size=5,
             kernel_max_roll=45.0, kernel_max_pitch=45.0, kernel_ang_res=22.5)
BOUNDS = (0.0, 30.0, 0.0, 14.0, 0.0, 15.0)
START, GOAL = np.array([5.0, 5.0, 5.0]), np.array([25.0, 5.0, 5.0])


def _cube():
    """tests/test_mesh.py's cube [−1, 1]³, 12 outward triangles."""
    V = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], float)
    F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                  [0, 5, 4], [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5],
                  [3, 0, 4], [3, 4, 7]], dtype=np.int32)
    return V, F


MESHES = {"L": meshlib.l_prism, "cube": _cube}


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    d = tmp_path_factory.mktemp("obj")
    out = {}
    for name, make in MESHES.items():
        out[name] = str(d / f"{name}.obj")
        meshlib.write_obj(out[name], *make())
    return out


def _cloud():
    cloud = maps_gen.map3(res=0.8, seed=0)
    return cloud[(cloud[:, 0] <= BOUNDS[1]) & (cloud[:, 1] <= BOUNDS[3])]


# ---------------------------------------------------------------------------
# the bake

@pytest.mark.parametrize("name", sorted(MESHES))
def test_obj_round_trip_and_mesh_geometry(objs, name):
    """The written OBJ loads back exactly through both loaders; the posed
    vertices and half-spaces equal JAX's to 1e-12; the faces point outward
    (the signed volume is the solid's)."""
    V0, F0 = MESHES[name]()
    V, F = meshlib.load_obj(objs[name])
    Vj, Fj = jmesh.load_obj(objs[name])
    np.testing.assert_array_equal(V, V0)
    np.testing.assert_array_equal(F, F0)
    np.testing.assert_array_equal(V, Vj)
    np.testing.assert_array_equal(F, Fj)
    np.testing.assert_allclose(meshlib.transform_mesh(V, POSE),
                               jmesh.transform_mesh(V, POSE), atol=1e-12)
    np.testing.assert_allclose(meshlib.h_poly(V, F), jmesh.h_poly(V, F),
                               atol=1e-12)
    # outward faces: the signed volume Σ a·(b × c) / 6 is the solid's volume
    a, b, c = (V[F[:, i]] for i in range(3))
    vol = np.einsum("ij,ij->", a, np.cross(b, c)) / 6
    assert vol == pytest.approx(
        (1.6 + 0.7) * 0.3 * 0.3 if name == "L" else 8.0, rel=1e-12)
    assert len(F) == (20 if name == "L" else 12)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_sdf_matches_jax(name):
    """mesh_sdf at points around and inside the mesh against JAX's, float64:
    1e-9 away from the surface, the sign included."""
    V, F = MESHES[name]()
    rng = np.random.default_rng(4)
    lo, hi = V.min(axis=0) - 0.7, V.max(axis=0) + 0.7
    pts = rng.uniform(lo, hi, size=(3000, 3))
    mine = meshlib.mesh_sdf(pts, V, F, chunk=1024, device="cpu", dtype=F64)
    theirs = np.asarray(jmesh.mesh_sdf(pts, V, F))
    away = np.abs(theirs) > SURFACE
    np.testing.assert_allclose(mine[away], theirs[away], rtol=0, atol=1e-9)
    assert (mine < 0).sum() > 20 and (mine > 0).sum() > 1000


def test_bake_sdf_grid_matches_jax():
    """The baked L field at demo 6's 0.05 m voxels with mesh_shape's 0.6 m
    margin: the grid's size, origin and spacing equal JAX's, and the float32
    field equals JAX's to float32 rounding away from the surface."""
    V, F = meshlib.l_prism()
    field, origin, res = meshlib.bake_sdf_grid(V, F, 0.05, 0.6,
                                               device="cpu", dtype=F64)
    fj, oj, rj = jmesh.bake_sdf_grid(V, F, 0.05, 0.6)
    assert field.dtype == np.float32 and field.shape == fj.shape
    assert field.shape == (57, 45, 31)
    np.testing.assert_array_equal(origin, oj)
    assert res == rj
    away = np.abs(fj) > SURFACE
    np.testing.assert_allclose(field[away], fj[away], rtol=2.0 ** -23,
                               atol=0)
    assert (field < 0).any() and field.max() > 0.6


# ---------------------------------------------------------------------------
# the front end

@pytest.fixture(scope="module")
def front(objs):
    conf = dict(FRONT, inputdata=objs["L"])
    jc, tc = JConfig(**conf), Config(**conf)
    js = jgridsdf.shape_from_config(jc)
    ts = shape_from_config(tc, device="cpu", dtype=F64)
    return dict(jc=jc, tc=tc, js=js, ts=ts,
                kj=jpk.build_pose_kernels(js, jc),
                kt=pose_kernels.build_pose_kernels(ts, tc, device="cpu"))


def test_shape_from_config_builds_the_grid_shape(front):
    """The config's OBJ goes to a grid shape: no device spec, the field
    equal to JAX's away from the surface, its bounds the posed mesh's
    extent."""
    js, ts = front["js"], front["ts"]
    assert ts.spec is None and ts.grid is not None
    assert ts.grid.device == torch.device("cpu")
    pg = js.grid                    # the JAX field, zero-padded for the TPU
    jfield = pg.field2d.reshape(-1, pg.nyp, pg.nzp)[:pg.nx, :pg.ny, :pg.nz]
    away = np.abs(jfield) > SURFACE
    np.testing.assert_array_equal(ts.grid.field.numpy()[away], jfield[away])
    np.testing.assert_array_equal(ts.grid.origin, pg.origin)
    assert ts.grid.res == pg.res
    assert ts.bounds == pytest.approx(js.bounds, abs=1e-12)


def test_pose_kernels_feasibility_and_astar_match_jax(front):
    """The L robot's pose kernels through shape.sdf, the pose-feasibility
    volume on the cropped map3 (exact booleans), and the SE(3) A* path from
    (5, 5, 5) to (25, 5, 5) through the first slit wall, equal to JAX's."""
    kj, kt = front["kj"], front["kt"]
    np.testing.assert_array_equal(kt.kernels.numpy(), np.asarray(kj.kernels))
    assert kt.kernels.any() and not kt.kernels.all()
    cloud = _cloud()
    jg = JGridMap.from_points(cloud, BOUNDS, 1.0, 1)
    tg = GridMap.from_points(cloud, BOUNDS, 1.0, 1, device="cpu")
    fj = np.asarray(jpk.pose_feasibility(jg.occ, kj.kernels))
    ft = pose_kernels.pose_feasibility(tg.occ, kt.kernels).numpy()
    np.testing.assert_array_equal(ft, fj)
    rj = jastar.astar_se3(jg, START, GOAL, fj, np.asarray(kj.rolls),
                          np.asarray(kj.pitches))
    rt = astar.astar_se3(tg, START, GOAL, ft, kt.rolls.numpy(),
                         kt.pitches.numpy())
    assert rt.success and rj.success
    np.testing.assert_array_equal(rt.path, rj.path)
    np.testing.assert_array_equal(rt.rolls, rj.rolls)
    np.testing.assert_array_equal(rt.pitches, rj.pitches)


# ---------------------------------------------------------------------------
# a short mesh plan

def test_short_mesh_plan_runs_on_the_plain_version(objs, monkeypatch):
    """PlannerManager.plan with the L robot on the cropped map3 (max_iters 3,
    coarse 32, rounds 8): it succeeds, its trajectory is finite and ends
    near start and goal, the audit is finite, and K3's plain version ran
    once per back-end evaluation and audit sweep while the kernel counter
    stayed put."""
    conf = Config(**dict(FRONT, inputdata=objs["L"], sweep_coarse_samples=32,
                         sweep_refine_rounds=8, integralIntervs=16,
                         max_obstacle_points=512, safety_hor=0.6,
                         vmax=10.0, omgmax=10.0, thetamax=100.0, rho=20.0))
    shape = shape_from_config(conf, device="cpu", dtype=F64)
    pm = PlannerManager(conf, shape=shape, device="cpu", dtype=F64)
    pm.set_map(GridMap.from_points(_cloud(), BOUNDS, 1.0, 1, device="cpu"))
    calls = [0]
    ref = grid_zoom.grid_sweep_warm_fused_ref

    def counted(*a, **k):
        calls[0] += 1
        return ref(*a, **k)

    monkeypatch.setattr(grid_zoom, "grid_sweep_warm_fused_ref", counted)
    before = grid_zoom.LAUNCHES_GRID
    res = pm.plan(START, GOAL, max_iters=3)
    m = res.metrics
    assert res.success, m
    assert grid_zoom.LAUNCHES_GRID == before
    audits = min(m.get("safety_replans", 0) + 1, conf.safety_replan_rounds)
    assert calls[0] == m["back_end_evals"] + audits
    assert np.isfinite(m["final_cost"])
    assert bool(torch.isfinite(res.traj.coeffs).all())
    ends = res.traj.junction_positions()[[0, -1]].numpy()
    assert np.linalg.norm(ends[0] - START) <= 6 * np.sqrt(3)
    assert np.linalg.norm(ends[1] - GOAL) <= 6 * np.sqrt(3)
    assert np.isfinite(pm.audit_collision(res.traj))
