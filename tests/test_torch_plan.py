"""The port's slice as a whole against isdf_tpu: PlannerManager.plan on
tests/test_e2e.py's wall scene (Ball body, the same Config), float64 on the
CPU, back end capped at 20 iterations on both sides.

Held: the A* paths and n_pieces are equal, the mid-end solution agrees to
rtol 1e-5, the final costs agree to within 2 % (the two back ends take
their line-search decisions on values that differ in the last digits, so
their iterates drift apart slowly), both audits find min SDF > 0, and the
trajectory ends lie within one voxel of start and goal."""

import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.opt import midend as jmidend
from isdf_tpu.plan import PlannerManager as JPlannerManager

from isdf_torch.config import Config
from isdf_torch.opt import midend
from isdf_torch.plan import PlannerManager
from isdf_torch.world import maps_gen

CONF = dict(
    mapBound=(0.0, 12.0, 0.0, 12.0, 0.0, 6.0),
    occupancy_resolution=0.5,
    kernel_size=5,
    kernel_max_roll=0.0, kernel_max_pitch=0.0, kernel_ang_res=9.0,
    integralIntervs=16,
    sweep_coarse_samples=32, sweep_refine_rounds=10,
    max_obstacle_points=512,
    inittime=2.0,
    vmax=5.0, omgmax=5.0, thetamax=1.5,
    safety_hor=0.3,
    traj_parlength=2.0,
)
START, GOAL = np.array([1.0, 5.0, 3.0]), np.array([10.5, 5.0, 3.0])
MAX_ITERS = 20


def _wall():
    return np.concatenate([
        maps_gen.gene_wall(5.0, 0.0, 1.0, 4.0, 6.0, res=0.25),
        maps_gen.gene_wall(5.0, 7.0, 1.0, 5.0, 6.0, res=0.25),
        maps_gen.gene_wall(5.0, 4.0, 1.0, 3.0, 1.0, res=0.25),
        maps_gen.gene_wall(5.0, 4.0, 1.0, 3.0, 2.0, oz=4.0, res=0.25),
    ])


def _capture_midend(module, store):
    orig = module.get_ori_traj

    def wrapped(*a, **k):
        out = orig(*a, **k)
        store.append(np.asarray(out[1]))
        return out

    return orig, wrapped


@pytest.fixture(scope="module")
def both():
    mids = {"jax": [], "torch": []}
    orig_j, midend_j = _capture_midend(jmidend, mids["jax"])
    orig_t, midend_t = _capture_midend(midend, mids["torch"])
    jmidend.get_ori_traj, midend.get_ori_traj = midend_j, midend_t
    try:
        jpm = JPlannerManager(JConfig(**CONF), shape_name="Ball")
        jpm.set_map_points(_wall())
        jres = jpm.plan(START, GOAL, max_iters=MAX_ITERS)
        tpm = PlannerManager(Config(**CONF), shape_name="Ball", device="cpu",
                             dtype=torch.float64)
        tpm.set_map_points(_wall())
        tres = tpm.plan(START, GOAL, max_iters=MAX_ITERS)
    finally:
        jmidend.get_ori_traj, midend.get_ori_traj = orig_j, orig_t
    return dict(jpm=jpm, jres=jres, tpm=tpm, tres=tres,
                xj=mids["jax"][0], xt=mids["torch"][0].copy())


def test_front_end_identical(both):
    jres, tres = both["jres"], both["tres"]
    assert jres.success and tres.success
    np.testing.assert_array_equal(tres.path, jres.path)
    assert tres.metrics["n_pieces"] == jres.metrics["n_pieces"]
    assert tres.metrics["parallel_points_num"] == \
        jres.metrics["parallel_points_num"]


def test_mid_end_agrees(both):
    np.testing.assert_allclose(both["xt"], both["xj"], rtol=1e-5, atol=1e-6)
    assert both["tres"].metrics["mid_end_iters"] == \
        both["jres"].metrics["mid_end_iters"]


def test_final_cost_agrees(both):
    fj = both["jres"].metrics["final_cost"]
    ft = both["tres"].metrics["final_cost"]
    assert np.isfinite(ft)
    assert abs(ft - fj) <= 0.02 * abs(fj), (ft, fj)


def test_audits_collision_free(both):
    assert both["jpm"].audit_collision(both["jres"].traj) > 0.0
    assert both["tpm"].audit_collision(both["tres"].traj) > 0.0


def test_endpoints_within_one_voxel(both):
    jp = both["tres"].traj.junction_positions().detach().numpy()
    np.testing.assert_allclose(jp[0], START, atol=0.5)
    np.testing.assert_allclose(jp[-1], GOAL, atol=0.5)
