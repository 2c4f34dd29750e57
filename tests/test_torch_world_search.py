"""isdf_torch map and front end against isdf_tpu on the CPU: occupancy and
ESDF, the pose kernels and the pose-feasibility volume (exact booleans),
and the SE(3) A* path (native core and Python twin)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.search import astar as jastar
from isdf_tpu.search import pose_kernels as jpk
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.world import GridMap as JGridMap
from isdf_tpu.world import maps_gen as jmaps_gen
from isdf_tpu.world.gridmap import _edt2 as jedt2

from isdf_torch.config import Config
from isdf_torch.search import astar, pose_kernels
from isdf_torch.shapes import make_shape
from isdf_torch.world import GridMap, maps_gen
from isdf_torch.world.gridmap import _edt2

CONF = dict(mapBound=(0.0, 12.0, 0.0, 12.0, 0.0, 6.0),
            occupancy_resolution=0.5, kernel_size=5,
            kernel_max_roll=18.0, kernel_max_pitch=18.0, kernel_ang_res=9.0,
            poly_params=(0.0, 0.0, 0.0, 30.0, 0.0, 0.0))


def _wall_scene():
    """tests/test_e2e.py's wall with a 3×3 m window."""
    return np.concatenate([
        maps_gen.gene_wall(5.0, 0.0, 1.0, 4.0, 6.0, res=0.25),
        maps_gen.gene_wall(5.0, 7.0, 1.0, 5.0, 6.0, res=0.25),
        maps_gen.gene_wall(5.0, 4.0, 1.0, 3.0, 1.0, res=0.25),
        maps_gen.gene_wall(5.0, 4.0, 1.0, 3.0, 2.0, oz=4.0, res=0.25),
    ])


def test_maps_gen_copy_matches():
    np.testing.assert_array_equal(maps_gen.map4(res=0.8, seed=3),
                                  jmaps_gen.map4(res=0.8, seed=3))


def test_gridmap_occupancy_and_esdf():
    pts = _wall_scene()
    jg = JGridMap.from_points(pts, CONF["mapBound"], 0.5, 1).with_esdf()
    tg = GridMap.from_points(pts, CONF["mapBound"], 0.5, 1,
                             device="cpu").with_esdf()
    np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(_edt2(tg.occ).numpy(),
                                  np.asarray(jedt2(jg.occ)))
    np.testing.assert_allclose(tg.esdf.numpy(), np.asarray(jg.esdf),
                               rtol=1e-6, atol=1e-6)
    # the cloud's own bounding box, as run_demo builds demo grids
    cloud = maps_gen.map4(res=0.8, seed=0)
    jg = JGridMap.from_points(cloud, None, 1.0, 1)
    tg = GridMap.from_points(cloud, None, 1.0, 1, device="cpu")
    np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))
    idx = np.array([[0, 0, 0], [3, 7, 2], [20, 11, 9]])
    np.testing.assert_allclose(
        tg.index_to_world(torch.as_tensor(idx)).numpy(),
        np.asarray(jg.index_to_world(jnp.asarray(idx))), rtol=1e-12)
    p = np.array([[0.3, 4.2, 7.7], [12.5, 1.0, 3.3]])
    np.testing.assert_array_equal(
        tg.world_to_index(torch.as_tensor(p)).numpy(),
        np.asarray(jg.world_to_index(jnp.asarray(p))))


@pytest.mark.parametrize("name", ["Ball", "RoundedCone"])
def test_pose_kernels_and_feasibility(name):
    conf = dict(CONF, kernel_size=9)
    jc, tc = JConfig(**conf), Config(**conf)
    kj = jpk.build_pose_kernels(jmake_shape(name, jc), jc)
    kt = pose_kernels.build_pose_kernels(make_shape(name, tc), tc,
                                         device="cpu")
    np.testing.assert_array_equal(kt.kernels.numpy(), np.asarray(kj.kernels))
    assert kt.kernels.any() and not kt.kernels.all()
    rng = np.random.default_rng(0)
    occ = rng.random((20, 16, 12)) < 0.002
    fj = np.asarray(jpk.pose_feasibility(jnp.asarray(occ), kj.kernels))
    ft = pose_kernels.pose_feasibility(torch.as_tensor(occ),
                                       kt.kernels).numpy()
    assert ft.dtype == bool
    np.testing.assert_array_equal(ft, fj)
    assert 0.05 < ft.mean() < 0.95


@pytest.mark.parametrize("use_native", [True, False])
def test_astar_se3_path(use_native):
    jc, tc = JConfig(**CONF), Config(**CONF)
    pts = _wall_scene()
    jg = JGridMap.from_points(pts, CONF["mapBound"], 0.5, 1)
    tg = GridMap.from_points(pts, CONF["mapBound"], 0.5, 1, device="cpu")
    kj = jpk.build_pose_kernels(jmake_shape("RoundedCone", jc), jc)
    kt = pose_kernels.build_pose_kernels(make_shape("RoundedCone", tc), tc,
                                         device="cpu")
    fj = np.asarray(jpk.pose_feasibility(jg.occ, kj.kernels))
    ft = pose_kernels.pose_feasibility(tg.occ, kt.kernels).numpy()
    start, goal = np.array([1.0, 5.0, 3.0]), np.array([10.5, 5.0, 3.0])
    rj = jastar.astar_se3(jg, start, goal, fj, np.asarray(kj.rolls),
                          np.asarray(kj.pitches), use_native=use_native)
    rt = astar.astar_se3(tg, start, goal, ft, kt.rolls.numpy(),
                         kt.pitches.numpy(), use_native=use_native)
    assert rt.success and rj.success
    np.testing.assert_array_equal(rt.path, rj.path)
    np.testing.assert_array_equal(rt.rolls, rj.rolls)
    np.testing.assert_array_equal(rt.pitches, rj.pitches)
    assert rt.expanded == rj.expanded
    np.testing.assert_array_equal(
        astar.subsample_waypoints(rt.path, 0.5, 2.0),
        jastar.subsample_waypoints(rj.path, 0.5, 2.0))
