"""isdf_torch's closed loop against isdf_tpu on the CPU: moving obstacles,
the trajectory server, the replan from a moving state and a short flight.

Held here:
  * MovingObstacle's dynamics, prediction and point cloud and compose_map
    exactly equal to JAX's (host numpy on both sides); predict_traj's MINCO
    fit to rtol 1e-10 (float64);
  * sample_horizon and TrajServer.command on one trajectory to rtol 1e-10,
    the rate-limited yaw chain included;
  * PlannerManager.plan(start_vel=, start_acc=) as tests/test_torch_plan.py
    holds a plan: the A* path identical, the mid end to rtol 1e-5, the
    final cost within 2 %;
  * tests/test_moving.py's flight (one obstacle on a deterministic arc) on
    both packages: the first replan agrees as a plan does, but for its mid
    end (below); each later replan starts from the state the previous plan
    commanded, so float64 rounding in L-BFGS moves the flights apart
    slowly, and the whole flight is held by its outcome: both reach the
    goal with the body SDF > 0 at every audited tick, in replan counts
    within one of each other.

The first replan's mid end (79 L-BFGS iterations on both sides) meets a
badly conditioned stretch: the two cost histories agree to 1e-14 through
iteration 30, then rounding grows (4e-9 at iteration 40, 1e-6 at 45) and
both stop 2.5e-4 m apart (measured, float64).  So that mid end is held by
its history over the first 30 iterations (rtol 1e-10) and its solution to
1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import minco as jminco
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.opt import midend as jmidend
from isdf_tpu.plan import PlannerManager as JPlannerManager
from isdf_tpu.plan import TrajServer as JTrajServer
from isdf_tpu.plan import fly_closed_loop as jfly_closed_loop
from isdf_tpu.plan.traj_server import sample_horizon as jsample_horizon
from isdf_tpu.world import moving as jmoving

from isdf_torch.config import Config
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import midend
from isdf_torch.plan import PlannerManager, TrajServer, fly_closed_loop
from isdf_torch.plan.closed_loop import _min_body_sdf, _occupied_centers
from isdf_torch.plan.traj_server import sample_horizon
from isdf_torch.world import GridMap, maps_gen, moving

F64 = torch.float64

# tests/test_moving.py's flight scene
FLY = dict(
    mapBound=(0.0, 14.0, 0.0, 10.0, 0.0, 4.0),
    occupancy_resolution=0.5, kernel_size=3, safety_hor=0.3,
    integralIntervs=8, sweep_coarse_samples=16, sweep_refine_rounds=6,
    max_obstacle_points=512, vmax=4.0, omgmax=6.0, thetamax=1.2, mem_size=8)
FLY_START, FLY_GOAL = np.array([1.0, 5.0, 2.0]), np.array([13.0, 5.0, 2.0])


def _static():
    return maps_gen.gene_wall(6.0, 0.0, 0.6, 3.5, 3.0, res=0.25)


# ---------------------------------------------------------------------------
# moving obstacles

def _obstacles(mod, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [mod.MovingObstacle(pos=rng.uniform((4, 2), (11, 8)),
                               vel=rng.normal(size=2), yaw=rng.uniform(-3, 3),
                               radius=0.4, height=3.0) for _ in range(n)]


def test_moving_obstacles_match_jax():
    jobs, tobs = _obstacles(jmoving), _obstacles(moving)
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(20):
        for jo, to in zip(jobs, tobs):
            a, yr = rj.uniform(0.5, 2.0), rj.uniform(-1.0, 1.0)
            b, zr = rt.uniform(0.5, 2.0), rt.uniform(-1.0, 1.0)
            jo.update(0.15, a, yr)
            to.update(0.15, b, zr)
    for jo, to in zip(jobs, tobs):
        np.testing.assert_array_equal(to.pos, jo.pos)
        np.testing.assert_array_equal(to.vel, jo.vel)
        assert to.yaw == jo.yaw
        for got, want in zip(to.predict(1.2, 0.3, 1.7),
                             jo.predict(1.2, 0.3, 1.7)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(to.points(res=0.2),
                                      jo.points(res=0.2))
    np.testing.assert_array_equal(
        moving.compose_map(_static(), tobs, res=0.25,
                           rng=np.random.default_rng(2)),
        jmoving.compose_map(_static(), jobs, res=0.25,
                            rng=np.random.default_rng(2)))


def test_predict_traj_matches_jax():
    jo, to = _obstacles(jmoving, n=1)[0], _obstacles(moving, n=1)[0]
    want = jmoving.predict_traj(jo, 0.8, 0.25, z=1.5)
    got = moving.predict_traj(to, 0.8, 0.25, z=1.5, device="cpu", dtype=F64)
    np.testing.assert_array_equal(got.durations.numpy(),
                                  np.asarray(want.durations))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               rtol=1e-10, atol=1e-10)
    p_mid, _ = to.predict(0.8, 0.25, 2.5)
    np.testing.assert_allclose(got.pos(2.5).numpy()[:2], p_mid, atol=1e-9)


# ---------------------------------------------------------------------------
# the trajectory server

def _serve_traj():
    """A 3-D trajectory that turns (the yaw chain's rate limit bites) and
    hovers at its end."""
    q = np.array([[2.0, 0.5, 1.0], [3.0, 3.0, 1.5], [1.0, 4.0, 1.2]])
    T = np.array([1.0, 0.8, 1.1, 0.9])
    tail = np.zeros((3, 3))
    tail[:, 0] = [-1.0, 3.0, 1.0]
    jt = JPolyTraj(jnp.asarray(T), jminco.solve(
        jnp.asarray(q), jnp.asarray(T), jnp.zeros((3, 3)), jnp.asarray(tail)))
    t64 = lambda a: torch.as_tensor(a, dtype=F64)
    tt = PolyTraj(t64(T), minco.solve(t64(q), t64(T),
                                      torch.zeros(3, 3, dtype=F64), t64(tail)))
    return jt, tt


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-10)


def test_sample_horizon_matches_jax():
    jt, tt = _serve_traj()
    for t0, last_yaw in ((0.0, 0.0), (1.3, 2.5), (3.1, -2.9)):
        want = jsample_horizon(jt, jnp.asarray(t0), 150, rate=100.0,
                               last_yaw=last_yaw)
        got = sample_horizon(tt, t0, 150, rate=100.0, last_yaw=last_yaw)
        _close(got, want)
    assert np.abs(np.diff(got.yaw)).max() <= np.pi / 2 / 100 + 1e-12
    assert np.all(got.velocity[-20:] == 0.0)        # past the end: hover


def test_traj_server_command_matches_jax():
    jt, tt = _serve_traj()
    js, ts = JTrajServer(rate=50.0), TrajServer(rate=50.0)
    js.set_trajectory(jt, stamp=100.0)
    ts.set_trajectory(tt, stamp=100.0)
    for now in np.arange(100.0, 104.5, 0.02):
        _close(ts.command(now), js.command(now))
        assert ts.last_yaw == pytest.approx(js.last_yaw, rel=1e-10,
                                            abs=1e-10)
    # the watchdog freezes the command once the heartbeat is stale
    js.last_heartbeat = ts.last_heartbeat = 103.0
    _close(ts.command(103.7), js.command(103.7))
    frozen = ts.command(103.9)
    assert np.all(frozen.velocity == 0.0) and float(frozen.yaw_dot) == 0.0


# ---------------------------------------------------------------------------
# the replan from a moving state, and a short flight

def _capture(module, store):
    """Wrap module.get_ori_traj to append its (solution, cost history)."""
    orig = module.get_ori_traj

    def wrapped(*a, **k):
        out = orig(*a, **k)
        store.append((np.asarray(out[1]), np.asarray(out[2].history)))
        return out

    module.get_ori_traj = wrapped
    return orig


def test_plan_from_a_moving_state_matches_jax():
    vel, acc = np.array([1.2, 0.3, -0.2]), np.array([0.5, -0.4, 0.1])
    mids = {"jax": [], "torch": []}
    orig_j = _capture(jmidend, mids["jax"])
    orig_t = _capture(midend, mids["torch"])
    pts = _static()
    try:
        jpm = JPlannerManager(JConfig(**FLY), shape_name="Ball")
        jpm.set_map_points(pts, use_pose_kernels=False)
        jres = jpm.plan(FLY_START, FLY_GOAL, max_iters=12, start_vel=vel,
                        start_acc=acc)
        tpm = PlannerManager(Config(**FLY), shape_name="Ball", device="cpu",
                             dtype=F64)
        tpm.set_map_points(pts, use_pose_kernels=False)
        tres = tpm.plan(FLY_START, FLY_GOAL, max_iters=12, start_vel=vel,
                        start_acc=acc)
    finally:
        jmidend.get_ori_traj, midend.get_ori_traj = orig_j, orig_t
    assert tpm.pose_kernels is None and tpm.feasibility is None
    assert jres.success and tres.success
    np.testing.assert_array_equal(tres.path, jres.path)
    np.testing.assert_allclose(mids["torch"][0][0], mids["jax"][0][0],
                               rtol=1e-5, atol=1e-6)
    fj, ft = jres.metrics["final_cost"], tres.metrics["final_cost"]
    assert abs(ft - fj) <= 0.02 * abs(fj), (ft, fj)
    # the trajectory starts in the commanded state
    _, v0, a0, _ = tres.traj.pvaj(torch.zeros((), dtype=F64))
    np.testing.assert_allclose(v0.detach().numpy(), vel, atol=1e-9)
    np.testing.assert_allclose(a0.detach().numpy(), acc, atol=1e-9)


def _controls(i, t, rng):
    return 0.6, 0.4                 # a deterministic gentle arc


def _fly(fly, pm, mod, store):
    plan = pm.plan

    def recording(*a, **k):
        res = plan(*a, **k)
        store.append(res)
        return res

    pm.plan = recording
    obstacles = [mod.MovingObstacle(pos=np.array([8.0, 7.0]), radius=0.4,
                                    height=3.0)]
    return fly(pm, _static(), obstacles, start=FLY_START, goal=FLY_GOAL,
               obstacle_controls=_controls, replan_dt=1.5, max_time=20.0,
               max_iters=12, goal_tol=1.0)


@pytest.fixture(scope="module")
def flights():
    plans = {"jax": [], "torch": []}
    mids = {"jax": [], "torch": []}
    orig_j = _capture(jmidend, mids["jax"])
    orig_t = _capture(midend, mids["torch"])
    try:
        jlog = _fly(jfly_closed_loop,
                    JPlannerManager(JConfig(**FLY), shape_name="Ball"),
                    jmoving, plans["jax"])
        tlog = _fly(fly_closed_loop,
                    PlannerManager(Config(**FLY), shape_name="Ball",
                                   device="cpu", dtype=F64),
                    moving, plans["torch"])
    finally:
        jmidend.get_ori_traj, midend.get_ori_traj = orig_j, orig_t
    return dict(jlog=jlog, tlog=tlog, plans=plans, mids=mids)


def test_first_replan_agrees(flights):
    jres, tres = flights["plans"]["jax"][0], flights["plans"]["torch"][0]
    assert jres.success and tres.success
    np.testing.assert_array_equal(tres.path, jres.path)
    (xt, ht), (xj, hj) = flights["mids"]["torch"][0], \
        flights["mids"]["jax"][0]
    np.testing.assert_allclose(ht[:30], hj[:30], rtol=1e-10)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-3)
    fj, ft = jres.metrics["final_cost"], tres.metrics["final_cost"]
    assert abs(ft - fj) <= 0.02 * abs(fj), (ft, fj)


def test_both_flights_reach_the_goal_clear(flights):
    jlog, tlog = flights["jlog"], flights["tlog"]
    assert jlog.reached and tlog.reached
    assert tlog.min_sdf > 0.0 and jlog.min_sdf > 0.0
    assert abs(len(tlog.replan_wall_s) - len(jlog.replan_wall_s)) <= 1
    assert len(tlog.replan_wall_s) >= 2
    assert len(tlog.setup_wall_s) == len(tlog.replan_wall_s)
    assert np.linalg.norm(tlog.positions[-1] - FLY_GOAL) < 1.0
    # commands are continuous across replans: no jump between ticks
    steps = np.linalg.norm(np.diff(np.asarray(tlog.positions), axis=0),
                           axis=1)
    assert steps.max() < FLY["vmax"] * 1.5 / 100


def test_min_body_sdf_matches_jax_audit():
    """The flight's audit on the device form of the occupied voxels against
    JAX's host form, at positions near the wall and far from it."""
    from isdf_tpu.plan.closed_loop import _min_body_sdf as j_min_body_sdf
    from isdf_tpu.world import GridMap as JGridMap

    pts = _static()
    jpm = JPlannerManager(JConfig(**FLY), shape_name="Ball")
    tpm = PlannerManager(Config(**FLY), shape_name="Ball", device="cpu",
                         dtype=F64)
    jgm = JGridMap.from_points(pts, FLY["mapBound"], 0.5, 1)
    gm = GridMap.from_points(pts, FLY["mapBound"], 0.5, 1, device="cpu")
    occ = _occupied_centers(gm, F64)
    np.testing.assert_allclose(occ.numpy(), jgm.occupied_centers(),
                               rtol=0, atol=1e-12)
    for pos in ([6.0, 1.0, 2.0], [5.6, 2.0, 1.0], [3.0, 5.0, 2.0]):
        want = j_min_body_sdf(jpm, np.asarray(pos), jgm)
        got = _min_body_sdf(tpm, np.asarray(pos), occ)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_live_view_waits_for_viz():
    pm = PlannerManager(Config(**FLY), shape_name="Ball", device="cpu")
    with pytest.raises(NotImplementedError, match="viz"):
        fly_closed_loop(pm, _static(), [], FLY_START, FLY_GOAL,
                        live_view=object())
