"""The chunked solve, the optimisation monitor and the checkpoint of
isdf_torch, against isdf_tpu where both run, float64 on the CPU.

* ``lbfgs.minimize`` with ``resume_state``/``trace_len`` and with
  ``consistent_baseline=False`` on Rosenbrock: the same iterations and
  evaluations as JAX's, iterates within 1e-8 (tests/test_torch_opt.py's
  band for this problem; 2e-7 without the re-evaluated baseline, which
  carries each iteration's rounding on).
* ``minimize_chunked`` equals ``minimize`` iterate for iterate (bitwise: the
  same operations in the same order) on a back-end cost.
* The monitored back end (``backend.optimize(monitor=)``): breakdowns that
  sum to their totals, the last one the cost of the last accepted trial, the
  Controller's stop after the first chunk, ``plan(monitor=)`` equal to the
  unmonitored plan.  The breakdown series against JAX's on the same solve
  is a full solve in both packages (~50 s of JAX compilation on the CPU):
  it is marked slow, and the card runs the monitored plan in chip_smoke.py.
* ``rot_to_quat`` on every branch and ``export_replay_csv`` against JAX's:
  1e-12; ``export_kernel_obj``.
* ``checkpoint``: a round trip, fingerprints equal to JAX's for equal
  configs, a JAX-saved file loaded by the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import so3 as jso3
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.opt import backend as jbackend
from isdf_tpu.opt import checkpoint as jcheckpoint
from isdf_tpu.opt import lbfgs as jlbfgs
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.utils import monitor as jmonitor

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, so3, timemap
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import backend, checkpoint, lbfgs
from isdf_torch.plan import PlannerManager
from isdf_torch.search.pose_kernels import build_pose_kernels
from isdf_torch.shapes import make_shape
from isdf_torch.utils import monitor
from isdf_torch.utils.obs import Controller
from isdf_torch.world import GridMap, maps_gen

from test_torch_lmbm import SCENE, small_scene

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _rosen(xp):
    def f(x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    return f


def _jcg(x, aux):
    f, g = jax.value_and_grad(_rosen(jnp))(x)
    return f, g, aux


def _tcg(x, aux):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        f = _rosen(torch)(xg)
        (g,) = torch.autograd.grad(f, xg)
    return f.detach(), g, aux


X0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.5, -1.0])
KW = dict(m=8, g_epsilon=1e-12, rel_cost_tol=0.0)


def test_resume_state_and_trace_len_match_jax():
    rj = jlbfgs.minimize(_jcg, jnp.asarray(X0), None, max_iters=7, **KW)
    rj = jlbfgs.minimize(_jcg, jnp.asarray(X0), None, max_iters=9,
                         resume_state=rj.state, trace_len=5, **KW)
    rt = lbfgs.minimize(_tcg, _t(X0), None, max_iters=7, **KW)
    rt = lbfgs.minimize(_tcg, _t(X0), None, max_iters=9,
                        resume_state=rt.state, trace_len=5, **KW)
    assert rt.n_iters == int(rj.n_iters) == 16
    assert rt.n_evals == int(rj.n_evals)
    assert rt.history.shape == (5,)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-10)


def test_resumed_converged_state_stays_converged():
    rt = lbfgs.minimize(_tcg, _t(X0), None, max_iters=200, m=8)
    assert rt.converged
    again = lbfgs.minimize(_tcg, _t(X0), None, max_iters=10, m=8,
                           resume_state=rt.state)
    assert (again.n_iters, again.n_evals) == (rt.n_iters, rt.n_evals)
    assert torch.equal(again.x, rt.x)


def test_baseline_skip_matches_jax():
    kw = dict(KW, max_iters=25, consistent_baseline=False)
    rj = jlbfgs.minimize(_jcg, jnp.asarray(X0), None, **kw)
    rt = lbfgs.minimize(_tcg, _t(X0), None, **kw)
    assert rt.n_iters == int(rj.n_iters)
    assert rt.n_evals == int(rj.n_evals)
    # no per-iteration re-evaluation: 1 + the line-search trials
    ref = lbfgs.minimize(_tcg, _t(X0), None, **dict(kw,
                                                    consistent_baseline=True))
    assert rt.n_evals < ref.n_evals
    # the reused baseline carries each iteration's rounding on: 4e-8
    # relative after 25 iterations (measured)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=2e-7,
                               atol=1e-10)


def _scene_cost(P=48):
    head, tail, q0, T0, pts, mask = small_scene(P)
    conf = Config(**SCENE)
    cg = backend.make_cost_fn(
        make_shape("Ball", conf), fl.FlatParams.from_config(conf),
        backend.BackendWeights.from_config(conf), _t(head), _t(tail), 4,
        _t(pts), torch.as_tensor(mask), integral_res=conf.integralIntervs,
        coarse_n=conf.sweep_coarse_samples,
        refine_rounds=conf.sweep_refine_rounds)
    x0 = backend.pack(timemap.T_to_tau(_t(T0)), _t(q0))
    return cg, x0, torch.zeros(len(pts), dtype=F64)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunked_equals_monolithic(chunk):
    cg, x0, tw = _scene_cost(P=6)
    mono = lbfgs.minimize(cg, x0, tw, m=8, max_iters=10)
    seen = []
    chunked = lbfgs.minimize_chunked(
        cg, x0, tw, m=8, max_iters=10, chunk=chunk,
        callback=lambda r: seen.append((r.n_iters, r.x.clone())))
    assert (chunked.n_iters, chunked.n_evals) == (mono.n_iters,
                                                  mono.n_evals)
    assert torch.equal(chunked.x, mono.x) and torch.equal(chunked.f, mono.f)
    assert torch.equal(chunked.aux, mono.aux)
    assert [n for n, _ in seen] == list(range(chunk, 10, chunk)) + [10]
    # the last chunk's trace holds the monolithic trace's last iterations
    k = 10 - seen[-2][0] if len(seen) > 1 else 10
    np.testing.assert_array_equal(chunked.history[:k].numpy(),
                                  mono.history[10 - k:].numpy())


def test_monitored_solve_streams_breakdowns():
    head, tail, q0, T0, pts, mask = small_scene(P=12)
    conf = Config(**SCENE)
    shape = make_shape("Ball", conf)
    mon = monitor.OptiMonitor()
    _, res = backend.optimize(shape, conf, head, tail, q0, T0, pts, mask,
                              max_iters=9, monitor=mon, monitor_chunk=4,
                              device="cpu", dtype=F64)
    _, plain = backend.optimize(shape, conf, head, tail, q0, T0, pts, mask,
                                max_iters=9, device="cpu", dtype=F64)
    assert (res.n_iters, res.n_evals) == (plain.n_iters, plain.n_evals)
    assert torch.equal(res.x, plain.x) and res.aux.shape == (len(pts),)
    assert mon.iters == [4, 8, 9] and mon.solves == 1
    for i in range(len(mon.total)):
        parts = mon.energy[i] + mon.time_cost[i] + mon.dyn[i] + mon.safety[i]
        np.testing.assert_allclose(mon.total[i], parts, rtol=1e-12)
    # the streamed total is the cost of the last accepted trial
    assert mon.total[-1] == float(res.f)
    assert "samples" in mon.cost_curve_ascii()
    assert mon.summary()["samples"] == 3


def test_controller_stops_the_solve():
    head, tail, q0, T0, pts, mask = small_scene(P=12)
    conf = Config(**SCENE)
    ctl = Controller()
    ctl.stop()
    mon = monitor.OptiMonitor(controller=ctl)
    _, res = backend.optimize(make_shape("Ball", conf), conf, head, tail, q0,
                              T0, pts, mask, max_iters=12, monitor=mon,
                              monitor_chunk=4, device="cpu", dtype=F64)
    assert res.n_iters == 4 and mon.iters == [4]
    assert not ctl.stop_requested            # the stop was consumed


@pytest.mark.slow
def test_monitored_solve_matches_jax(record_property):
    """The breakdown series of one monitored solve in both packages: at
    coarse_n = 60 both sweep through the non-fused path."""
    head, tail, q0, T0, pts, mask = small_scene()
    jc, tc = JConfig(**SCENE), Config(**SCENE)
    jm, tm = jmonitor.OptiMonitor(), monitor.OptiMonitor()
    _, rj = jbackend.optimize(
        jmake_shape("Ball", jc), jc, *(jnp.asarray(a) for a in (
            head, tail, q0, T0, pts, mask)), max_iters=12, monitor=jm,
        monitor_chunk=4)
    _, rt = backend.optimize(make_shape("Ball", tc), tc, head, tail, q0, T0,
                             pts, mask, max_iters=12, monitor=tm,
                             monitor_chunk=4, device="cpu", dtype=F64)
    record_property("breakdowns", len(tm.iters))
    record_property("total_rel_gap", float(np.max(np.abs(
        np.asarray(tm.total) / np.asarray(jm.total) - 1.0))))
    assert tm.iters == jm.iters
    for a, b in ((tm.total, jm.total), (tm.energy, jm.energy),
                 (tm.time_cost, jm.time_cost), (tm.dyn, jm.dyn),
                 (tm.safety, jm.safety)):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
    assert (rt.n_iters, rt.n_evals) == (int(rj.n_iters), int(rj.n_evals))


PLAN_CONF = dict(
    mapBound=(0.0, 12.0, 0.0, 12.0, 0.0, 6.0), occupancy_resolution=0.5,
    kernel_size=5, kernel_max_roll=0.0, kernel_max_pitch=0.0,
    kernel_ang_res=9.0, integralIntervs=8, sweep_coarse_samples=32,
    sweep_refine_rounds=8, max_obstacle_points=256, inittime=2.0, vmax=5.0,
    omgmax=5.0, thetamax=1.5, safety_hor=0.3, traj_parlength=2.0)


def _wall_manager():
    pm = PlannerManager(Config(**PLAN_CONF), shape_name="Ball", device="cpu",
                        dtype=F64)
    pts = np.concatenate([
        maps_gen.gene_wall(5.0, 0.0, 1.0, 4.0, 6.0, res=0.25),
        maps_gen.gene_wall(5.0, 7.0, 1.0, 5.0, 6.0, res=0.25)])
    pm.set_map(GridMap.from_points(pts, PLAN_CONF["mapBound"], 0.5, 1,
                                   device="cpu"))
    return pm


def test_plan_with_monitor_equals_plan():
    pm = _wall_manager()
    start, goal = np.array([1.0, 5.0, 3.0]), np.array([10.5, 5.0, 3.0])
    plain = pm.plan(start, goal, max_iters=8)
    mon = monitor.OptiMonitor()
    watched = pm.plan(start, goal, max_iters=8, monitor=mon)
    assert plain.success and watched.success
    for k in ("back_end_iters", "back_end_evals", "final_cost"):
        assert watched.metrics[k] == plain.metrics[k], k
    assert mon.solves == 1 + watched.metrics.get("safety_replans", 0)
    assert len(mon.total) >= mon.solves
    assert pm.audit_collision(watched.traj, n_samples=400) == \
        pm.audit_collision(watched.traj)


def test_rot_to_quat_matches_jax_on_every_branch():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(64, 4))
    # rotations near identity (the trace branch) and by ~180° about x, y and
    # z (the diagonal branches)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    q[4:8] += [[0, 0, 0, 0], [0, 5, 0, 0], [0, 0, 5, 0], [0, 0, 0, 5]]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jso3.quat_to_rot(jnp.asarray(q)))
    branch = np.argmax(np.stack([1 + np.trace(R, axis1=1, axis2=2)] + [
        1 + 2 * R[:, k, k] - np.trace(R, axis1=1, axis2=2)
        for k in range(3)], axis=1), axis=1)
    assert set(branch) == {0, 1, 2, 3}
    qj = np.asarray(jso3.rot_to_quat(jnp.asarray(R)))
    qt = so3.rot_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)
    assert (qt[:, 0] >= 0).all()


def _trajs(N=3, seed=2):
    rng = np.random.default_rng(seed)
    q = np.linspace(1, 4, N - 1)[:, None] * np.array([1.0, 0.4, 0.2]) \
        + rng.normal(scale=0.3, size=(N - 1, 3))
    T = rng.uniform(0.8, 1.4, size=N)
    tail = np.zeros((3, 3))
    tail[:, 0] = [5.0, 2.0, 1.0]
    c = minco.solve(_t(q), _t(T), torch.zeros(3, 3, dtype=F64), _t(tail))
    return (JPolyTraj(jnp.asarray(T), jnp.asarray(c.numpy())),
            PolyTraj(_t(T), c))


@pytest.mark.parametrize("planar", [False, True])
def test_export_replay_csv_matches_jax(tmp_path, planar):
    jtraj, ttraj = _trajs()
    jp, tp = ((jfl.PlanarPose(0.5), fl.PlanarPose(0.5)) if planar else
              (jfl.FlatParams(), fl.FlatParams()))
    jmonitor.export_replay_csv(str(tmp_path / "j.csv"), jtraj, jp, fps=20.0)
    monitor.export_replay_csv(str(tmp_path / "t.csv"), ttraj, tp, fps=20.0)
    rj = np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1)
    rt = np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1)
    assert rt.shape == rj.shape and rt.shape[1] == 8
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12)


def test_export_kernel_obj(tmp_path):
    conf = Config(kernel_size=5, kernel_max_roll=45.0, kernel_max_pitch=45.0)
    pk = build_pose_kernels(make_shape("Ball", conf), conf, device="cpu")
    path = monitor.export_kernel_obj(str(tmp_path / "k.obj"), pk,
                                     resolution=0.5)
    lines = open(path).read().splitlines()
    n = int(pk.kernels[pk.kernels.shape[0] // 2,
                       pk.kernels.shape[1] // 2].sum())
    assert n > 0
    assert sum(ln.startswith("v ") for ln in lines) == 8 * n
    assert sum(ln.startswith("f ") for ln in lines) == 6 * n


def test_checkpoint_round_trip_and_fingerprint(tmp_path):
    kw = dict(SCENE, safety_hor=0.35)
    jc, tc = JConfig(**kw), Config(**kw)
    for N, P in ((4, 48), (7, 1)):
        assert checkpoint.problem_fingerprint(tc, N, P) == \
            jcheckpoint.problem_fingerprint(jc, N, P)
    assert checkpoint.problem_fingerprint(tc, 4, 48) != \
        checkpoint.problem_fingerprint(Config(**SCENE), 4, 48)
    rng = np.random.default_rng(1)
    x, ts = _t(rng.normal(size=13)), _t(rng.uniform(size=48))
    path = os.path.join(tmp_path, "port.npz")
    checkpoint.save(path, x, ts, tc, extra={"it": np.asarray(5)})
    x2, t2, fp = checkpoint.load(path)
    np.testing.assert_array_equal(x2, x.numpy())
    np.testing.assert_array_equal(t2, ts.numpy())
    assert fp == jcheckpoint.problem_fingerprint(jc, 0, 48)
    # a file saved by the JAX package loads in the port, and back
    jpath = os.path.join(tmp_path, "jax.npz")
    jcheckpoint.save(jpath, jnp.asarray(x.numpy()), jnp.asarray(ts.numpy()),
                     jc)
    for a, b in zip(checkpoint.load(jpath), jcheckpoint.load(path)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resume: the loaded state is a valid point of the cost
    cg, _, _ = _scene_cost()
    f, g, _ = cg(torch.as_tensor(x2), torch.as_tensor(t2))
    assert np.isfinite(float(f)) and bool(torch.isfinite(g).all())
