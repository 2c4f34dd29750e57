"""isdf_torch's planar (SE(2)) planning against isdf_tpu on the CPU.

The third trajectory coordinate is the yaw ψ and the pose is ((x, y,
z_ref), Rz(ψ)) (core/flatness.PlanarPose).  Held here:
  * the pose map and the rates (float64, rtol 1e-12) and the component-form
    pose map;
  * the plain versions of K1 and K3 under PlanarPose against JAX's XLA
    sweep, float32, in the bands of tests/test_torch_sweep.py and
    tests/test_torch_grid_sweep.py;
  * the spinning bar of tests/test_planar.py through the port;
  * the planar integral penalty and the whole back-end cost and gradient
    (float64, rtol 1e-8);
  * the grid map's inflation, occupancy queries and trilinear ESDF;
  * a small plan_planar on both packages (a cut planar_gaps): the A* path
    identical, the mid end to rtol 1e-5, the final cost within 2 % (as
    tests/test_torch_plan.py holds the 3-D plan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import minco as jminco
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.opt import backend as jbackend
from isdf_tpu.opt import midend as jmidend
from isdf_tpu.plan import planar as jplanar
from isdf_tpu.shapes import gridsdf as jgridsdf
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.sweep import fast_eval as jfast_eval
from isdf_tpu.sweep.sweep_sdf import sdf_at_time as jsdf_at_time
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_warm as jsweep_sdf_warm
from isdf_tpu.world import GridMap as JGridMap

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import backend, midend
from isdf_torch.plan import planar
from isdf_torch.shapes import grid_shape, make_shape
from isdf_torch.sweep import fused_zoom, grid_zoom
from isdf_torch.sweep.fast_eval import pose_components
from isdf_torch.sweep.sweep_sdf import sweep_sdf, sweep_sdf_warm, traj_states
from isdf_torch.world import GridMap, maps_gen

F32, F64 = torch.float32, torch.float64
D_ATOL, D_RTOL, G_ATOL, T_AGREE = 2e-4, 1e-4, 1e-3, 1e-4
BAR = dict(box_x=1.4, box_y=0.2, box_z=0.2)
PLANAR = dict(vmax=4.0, omgmax=3.0, thetamax=1e3, safety_hor=0.25,
              weight_p=8000.0)
# bounds the test trajectories exceed, so the planar speed and yaw-rate
# penalties are active
TIGHT = dict(PLANAR, vmax=1.0, omgmax=0.2)


def _planar_traj(dtype, N=5, seed=0):
    """(q, T, head, tail) of a planar (x, y, ψ) trajectory whose yaw turns
    by ~1.5 rad."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 1, N + 1)[1:-1, None]
    q = (u * np.array([8.0, 6.0, 1.5])
         + rng.normal(scale=[0.3, 0.3, 0.2], size=(N - 1, 3)))
    T = rng.uniform(1.2, 2.2, size=N)
    head = np.zeros((3, 3))
    tail = np.zeros((3, 3))
    tail[:, 0] = [8.0, 6.0, 1.5]
    return q, T, head, tail


def _both_trajs(dtype, **kw):
    q, T, head, tail = _planar_traj(dtype, **kw)
    jdt = jnp.float32 if dtype == F32 else jnp.float64
    f = lambda a: jnp.asarray(a, jdt)
    g = lambda a: torch.as_tensor(a, dtype=dtype)
    jtraj = JPolyTraj(f(T), jminco.solve(f(q), f(T), f(head), f(tail)))
    ttraj = PolyTraj(g(T), minco.solve(g(q), g(T), g(head), g(tail)))
    return jtraj, ttraj, f, g


def _plane_points(P, seed=1, lo=-1.0, hi=9.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(lo, hi, size=(P, 2))
    return np.concatenate([xy, np.zeros((P, 1))], axis=1)


# ---------------------------------------------------------------------------
# the pose map

def test_pose_of_and_rates_of_match_jax():
    rng = np.random.default_rng(0)
    pos, vel, acc, jer = (rng.normal(scale=2.0, size=(7, 3)) for _ in
                          range(4))
    jp, tp = jfl.PlanarPose(z_ref=0.8), fl.PlanarPose(z_ref=0.8)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    for jf, tf in ((jfl.pose_of, fl.pose_of), (jfl.rates_of, fl.rates_of)):
        want = jf(*(jnp.asarray(a) for a in (pos, vel, acc, jer)), jp)
        got = tf(*(t(a) for a in (pos, vel, acc, jer)), tp)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-14)
    pos3, R = fl.pose_of(t([2.0, 3.0, np.pi / 2]), *(t(np.zeros(3)),) * 3,
                         fl.PlanarPose(z_ref=1.0))
    np.testing.assert_allclose(pos3.numpy(), [2.0, 3.0, 1.0], atol=1e-12)
    np.testing.assert_allclose(R.numpy(), [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                               atol=1e-12)


def test_pose_components_match_jax():
    rng = np.random.default_rng(1)
    comps = [tuple(rng.normal(size=11) for _ in range(3)) for _ in range(3)]
    want = jfast_eval.pose_components(
        *(tuple(jnp.asarray(c) for c in cs) for cs in comps),
        jfl.PlanarPose(z_ref=-0.3))
    got = pose_components(
        *(tuple(torch.as_tensor(c) for c in cs) for cs in comps),
        fl.PlanarPose(z_ref=-0.3))
    for g3, w3 in zip(got, want):
        for a, b in zip(g3, w3):
            np.testing.assert_allclose(a.numpy(), np.broadcast_to(
                np.asarray(b), a.shape), rtol=1e-12, atol=1e-15)


def test_traj_states_put_z_ref_in_the_pose_table():
    _, traj, _, _ = _both_trajs(F64)
    ts = torch.linspace(0.0, float(traj.total_duration), 16, dtype=F64)
    xs, Rs = traj_states(traj, fl.PlanarPose(z_ref=0.4), ts)
    psi = traj.pos(ts)[:, 2]
    assert torch.all(xs[:, 2] == 0.4)
    np.testing.assert_allclose(Rs[:, 0, 0].numpy(), torch.cos(psi).numpy())
    np.testing.assert_allclose(Rs[:, 1, 0].numpy(), torch.sin(psi).numpy())


# ---------------------------------------------------------------------------
# K1's and K3's plain versions under PlanarPose

def _box_kink(t_star, traj, params, pts, half, eps=1e-3):
    """Points inside the box at t* whose two largest |q| − b lie within
    eps: the kink of the box SDF's max, where the gradient switches face."""
    with torch.no_grad():
        pos, vel, acc, _ = traj.pvaj(torch.as_tensor(t_star))
        x3, R = fl.pose_of(pos, vel, acc, None, params)
        d = torch.as_tensor(pts, dtype=x3.dtype) - x3
        q = torch.einsum("pji,pj->pi", R, d).abs().numpy()
    q = q - np.array([half["box_x"], half["box_y"], half["box_z"]])
    top = np.sort(q, axis=1)
    return (top[:, 2] < 0) & (top[:, 2] - top[:, 1] < eps)


@pytest.mark.parametrize("name", ["Box", "Ball"])
def test_planar_k1_plain_version_matches_jax(name):
    jtraj, traj, f, g = _both_trajs(F32)
    conf = dict(PLANAR, **BAR)
    js, ts_ = jmake_shape(name, JConfig(**conf)), make_shape(name,
                                                             Config(**conf))
    pts = _plane_points(160)
    tw = np.random.default_rng(2).uniform(0, float(traj.total_duration),
                                          size=len(pts))
    s_j, t_j, g_j = (np.asarray(a) for a in jsweep_sdf_warm(
        js, jtraj, jfl.PlanarPose(0.0), f(pts), f(tw), coarse_n=32,
        refine_rounds=8, use_pallas=False))
    params = fl.PlanarPose(0.0)
    tsamp = torch.linspace(0.0, 1.0, 32, dtype=F32) * traj.total_duration
    xs, Rs = traj_states(traj, params, tsamp)
    pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1)
    starts = torch.cumsum(traj.durations, 0) - traj.durations
    t_r, d_r, g_r = (a.numpy() for a in fused_zoom.sweep_warm_fused_ref(
        ts_, params, g(pts), g(tw), pose, starts, traj.durations,
        traj.coeffs, coarse_n=32, rounds=8))
    np.testing.assert_allclose(d_r, s_j, atol=D_ATOL, rtol=D_RTOL)
    ok = np.abs(t_r - t_j) < T_AGREE
    assert ok.mean() > 0.9
    if name == "Box":
        # inside the bar the SDF is max(|q| − b), and while the bar turns
        # the minimum over time of that max sits where two of its arguments
        # cross: there a shift of t* by an ulp-level 1e-5 s picks the other
        # face's gradient.  Hold the gradient off that kink.
        ok &= ~_box_kink(t_r, traj, params, pts, BAR)
        assert ok.mean() > 0.85
    np.testing.assert_allclose(g_r[ok], g_j[ok], atol=G_ATOL)
    # the entry point on CPU tensors runs that plain version
    before = fused_zoom.LAUNCHES
    s_t = sweep_sdf_warm(ts_, traj, params, g(pts), g(tw), coarse_n=32,
                         refine_rounds=8, device="cpu")[0]
    assert fused_zoom.LAUNCHES == before
    np.testing.assert_allclose(s_t.detach().numpy(), s_j, atol=D_ATOL,
                               rtol=D_RTOL)


def test_planar_k3_plain_version_matches_jax():
    """K3's plain version under PlanarPose on a torus field against JAX's
    warm sweep (its XLA path), in tests/test_torch_grid_sweep.py's bands:
    SDF within 1.5 % + 0.015, the depth at the port's t* at most 6e-2 above
    the depth at JAX's t*, the gradient within 0.1 where the t* agree to
    1e-3."""
    n, res = 24, 0.1
    origin = np.full(3, -1.2)
    ii = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), axis=-1)
    p = origin + ii * res
    field = (np.sqrt((np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.6) ** 2
                     + p[..., 2] ** 2) - 0.25).astype(np.float32)
    jshape = jgridsdf.grid_shape("t24f", field, origin, res)
    shape = grid_shape("t24f", field, origin, res, device="cpu")
    jtraj, traj, f, g = _both_trajs(F32)
    pts = _plane_points(200, seed=3)
    pts[:, 2] = np.random.default_rng(4).uniform(-0.3, 0.3, size=len(pts))
    tw = np.random.default_rng(5).uniform(0, float(traj.total_duration),
                                          size=len(pts))
    jp, tp = jfl.PlanarPose(0.0), fl.PlanarPose(0.0)
    s_j, t_j, g_j = (np.asarray(a) for a in jsweep_sdf_warm(
        jshape, jtraj, jp, f(pts), f(tw), coarse_n=32, refine_rounds=8,
        use_pallas=False))
    durs = traj.durations
    t_t, d_t, g_t = (a.numpy() for a in grid_zoom.grid_sweep_warm_fused(
        shape.grid, tp, g(pts), g(tw), torch.cumsum(durs, 0) - durs, durs,
        traj.coeffs, coarse_n=32, rounds=8))
    assert (np.abs(d_t - s_j) <= 0.015 * np.abs(s_j) + 0.015).all()
    d_at_t = np.asarray(jsdf_at_time(jshape, jtraj, jp, f(pts), f(t_t)))
    d_at_j = np.asarray(jsdf_at_time(jshape, jtraj, jp, f(pts), f(t_j)))
    assert (d_at_t <= d_at_j + 6e-2).all()
    near = np.abs(t_t - t_j) < 1e-3
    # the torus SDF has a kink on its tube's centre circle, where the swept
    # minimum of a point in the ring's plane sits: hold the gradient off it
    with torch.no_grad():
        pos, vel, acc, _ = traj.pvaj(torch.as_tensor(t_t))
        x3, R = fl.pose_of(pos, vel, acc, None, tp)
        q = torch.einsum("pji,pj->pi", R, g(pts) - x3).numpy()
    ring = np.hypot(np.hypot(q[:, 0], q[:, 1]) - 0.6, q[:, 2])
    near &= ring > 0.02
    assert near.sum() >= 20
    np.testing.assert_allclose(g_t[near], g_j[near], atol=0.1)


def test_spinning_bar_sweeps_a_disk():
    """tests/test_planar.py's bar (half-length 2) spinning in place: inside
    the swept disk the swept SDF is −(half-width), outside ≈ r − 2."""
    shape = make_shape("Box", Config(box_x=2.0, box_y=0.2, box_z=0.2))
    q = torch.tensor([[0.0, 0.0, np.pi]], dtype=F64)
    T = torch.tensor([2.0, 2.0], dtype=F64)
    tail = torch.zeros(3, 3, dtype=F64)
    tail[2, 0] = 2 * np.pi
    traj = PolyTraj(T, minco.solve(q, T, torch.zeros(3, 3, dtype=F64), tail))
    pts = torch.tensor([[1.5, 0.0, 0.0], [0.0, 1.5, 0.0], [-1.0, 1.0, 0.0],
                        [2.5, 0.0, 0.0], [0.0, -3.0, 0.0]], dtype=F64)
    sdf = sweep_sdf(shape, traj, fl.PlanarPose(0.0), pts,
                    device="cpu")[0].detach().numpy()
    np.testing.assert_allclose(sdf[:3], -0.2, atol=0.05)
    np.testing.assert_allclose(sdf[3], 0.5, atol=0.1)
    np.testing.assert_allclose(sdf[4], 1.0, atol=0.1)


# ---------------------------------------------------------------------------
# the planar penalties and the back-end cost

def test_planar_integral_penalty_matches_jax():
    jtraj, traj, _, _ = _both_trajs(F64)
    jc, tc = JConfig(**TIGHT), Config(**TIGHT)
    want = jbackend.integral_penalty(jtraj, jfl.PlanarPose(0.0),
                                     jbackend.BackendWeights.from_config(jc),
                                     16)
    got = backend.integral_penalty(traj, fl.PlanarPose(0.0),
                                   backend.BackendWeights.from_config(tc), 16)
    assert float(want) > 1.0          # the yaw rate and speed bounds bite
    np.testing.assert_allclose(float(got), float(want), rtol=1e-8)


def test_planar_backend_cost_and_gradient_match_jax():
    """make_cost_fn under PlanarPose, float64: the energy, the time cost,
    the planar integral penalty and the swept penalty over the obstacle
    points whose t* the two sweeps find alike (to 1e-12 s; off the piece
    junctions, where the frozen-t* gradient jumps) — value and gradient to
    rtol 1e-8.  The rest sit inside the bar, where its SDF is flat
    (−half-width) over an interval of time and the plateau pick of the two
    sweeps may land 1e-5 s apart at an SDF 1e-5 apart."""
    N = 5
    q, T, head, tail = _planar_traj(F64, N=N, seed=6)
    x = np.concatenate([np.log(T) * 0.5, q.ravel()])
    conf = dict(TIGHT, **BAR)
    jc, tc = JConfig(**conf), Config(**conf)
    js, ts_ = jmake_shape("Box", jc), make_shape("Box", tc)
    jp, tp = jfl.PlanarPose(0.0), fl.PlanarPose(0.0)
    pts = _plane_points(96, seed=7, lo=0.5, hi=7.5)
    tw = np.random.default_rng(8).uniform(0.0, 4.0, size=len(pts))
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    g64 = lambda a: torch.as_tensor(a, dtype=F64)
    jtraj, _, _ = jbackend.build_traj(f64(x), N, f64(head), f64(tail))
    t_j = np.asarray(jsweep_sdf_warm(js, jtraj, jp, f64(pts), f64(tw),
                                     coarse_n=32, refine_rounds=8)[1])
    ttraj, _, _ = backend.build_traj(g64(x), N, g64(head), g64(tail))
    t_t = sweep_sdf_warm(ts_, ttraj, tp, g64(pts), g64(tw), coarse_n=32,
                         refine_rounds=8, device="cpu")[1].numpy()
    junctions = np.cumsum(ttraj.durations.numpy())[:-1]
    off = np.abs(t_t[:, None] - junctions[None, :]).min(axis=1) > 1e-3
    mask = (np.abs(t_j - t_t) < 1e-12) & off
    assert mask.mean() > 0.7

    jcg = jbackend.make_cost_fn(
        js, jp, jbackend.BackendWeights.from_config(jc), f64(head),
        f64(tail), N, f64(pts), jnp.asarray(mask), integral_res=16,
        coarse_n=32, refine_rounds=8)
    fj, gj, _ = jcg(f64(x), f64(tw))
    tcg = backend.make_cost_fn(
        ts_, tp, backend.BackendWeights.from_config(tc), g64(head),
        g64(tail), N, g64(pts), torch.as_tensor(mask), integral_res=16,
        coarse_n=32, refine_rounds=8)
    ft, gt, _ = tcg(g64(x), g64(tw))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-8,
                               atol=1e-8 * np.abs(gj).max())


# ---------------------------------------------------------------------------
# the grid map's planar-planner and flight-audit helpers

def _maps():
    pts = np.concatenate([maps_gen.gene_wall(3.0, 0.0, 0.5, 4.0, 2.0,
                                             res=0.25),
                          np.random.default_rng(9).uniform(0, 8, (60, 3))])
    bounds = (0.0, 8.0, 0.0, 8.0, 0.0, 3.0)
    return (JGridMap.from_points(pts, bounds, 0.5, 1),
            GridMap.from_points(pts, bounds, 0.5, 1, device="cpu"))


def test_gridmap_occupancy_helpers_match_jax():
    jgm, gm = _maps()
    np.testing.assert_array_equal(gm.occupied_centers(),
                                  jgm.occupied_centers())
    for r in (1, 2):
        np.testing.assert_array_equal(gm.inflated(r).occ.numpy(),
                                      np.asarray(jgm.inflated(r).occ))
    q = np.random.default_rng(10).uniform(-1.0, 9.0, size=(200, 3))
    np.testing.assert_array_equal(
        gm.is_occupied(torch.as_tensor(q)).numpy(),
        np.asarray(jgm.is_occupied(jnp.asarray(q))))


def test_gridmap_trilinear_esdf_matches_jax():
    jgm, gm = _maps()
    jgm, gm = jgm.with_esdf(), gm.with_esdf()
    q = np.random.default_rng(11).uniform(-0.5, 8.5, size=(300, 3))
    vj, gj = jgm.sdf_value_grad(jnp.asarray(q))
    vt, gt = gm.sdf_value(torch.as_tensor(q)), gm.sdf_grad(torch.as_tensor(q))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# a small planar plan on both packages

PLAN_CONF = dict(
    occupancy_resolution=0.5, integralIntervs=16, sweep_coarse_samples=32,
    sweep_refine_rounds=8, vmax=4.0, omgmax=3.0, thetamax=1e3,
    safety_hor=0.25, max_obstacle_points=512, inittime=2.0, weight_p=8000.0,
    box_x=0.9, box_y=0.2, box_z=0.2)


def _capture(module, store):
    orig = module.get_ori_traj

    def wrapped(*a, **k):
        out = orig(*a, **k)
        store.append(np.asarray(out[1]))
        return out

    module.get_ori_traj = wrapped
    return orig


@pytest.fixture(scope="module")
def plans():
    """demo 8's scene cut to a 12 m arena (walls at x = 4 and 8), a 1.8 m
    bar, the back end capped at 6 iterations, float64 on both sides."""
    pts2 = maps_gen.planar_gaps(area=12.0, walls=(4.0, 8.0))
    mids = {"jax": [], "torch": []}
    orig_j = _capture(jmidend, mids["jax"])
    orig_t = _capture(midend, mids["torch"])
    try:
        jc, tc = JConfig(**PLAN_CONF), Config(**PLAN_CONF)
        jshape, shape = jmake_shape("Box", jc), make_shape("Box", tc)
        jres = jplanar.plan_planar(jc, jshape, pts2, (1.5, 1.5),
                                   (10.5, 10.5), yaw_opt=True, max_iters=6)
        tres = planar.plan_planar(tc, shape, pts2, (1.5, 1.5), (10.5, 10.5),
                                  yaw_opt=True, max_iters=6, device="cpu",
                                  dtype=F64)
    finally:
        jmidend.get_ori_traj, midend.get_ori_traj = orig_j, orig_t
    return dict(jres=jres, tres=tres, xj=mids["jax"][0],
                xt=mids["torch"][0].copy(), pts2=pts2, jshape=jshape,
                shape=shape)


def test_planar_front_end_identical(plans):
    jres, tres = plans["jres"], plans["tres"]
    assert jres.success and tres.success
    np.testing.assert_array_equal(tres.path, jres.path)
    for k in ("n_pieces", "parallel_points_num"):
        assert tres.metrics[k] == jres.metrics[k]


def test_planar_mid_end_agrees(plans):
    np.testing.assert_allclose(plans["xt"], plans["xj"], rtol=1e-5,
                               atol=1e-6)


def test_planar_final_cost_and_audit(plans):
    fj = plans["jres"].metrics["final_cost"]
    ft = plans["tres"].metrics["final_cost"]
    assert np.isfinite(ft)
    assert abs(ft - fj) <= 0.02 * abs(fj), (ft, fj)
    # the audit over the map's points: the port's own value, and JAX's
    # audit of JAX's plan, both on the same side of zero
    a_t = planar.audit_planar(plans["shape"], plans["tres"].traj,
                              plans["pts2"], device="cpu")
    a_j = jplanar.audit_planar(plans["jshape"], plans["jres"].traj,
                               plans["pts2"])
    assert np.isfinite(a_t)
    assert (a_t > 0) == (a_j > 0), (a_t, a_j)
    assert plans["tres"].metrics["min_swept_sdf"] == pytest.approx(
        plans["jres"].metrics["min_swept_sdf"], abs=0.05)


def test_plan_planar_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        planar.plan_planar(Config(**PLAN_CONF), make_shape("Ball"),
                           maps_gen.planar_gaps(area=12.0, walls=(4.0, 8.0)),
                           (1.5, 1.5), (10.5, 10.5))
