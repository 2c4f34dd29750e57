"""isdf_torch swept SDF against isdf_tpu, float32 on the CPU.

On the CPU JAX's warm sweep takes its XLA path, which runs the same dual k=8
plateau zoom as the TPU kernel (K1), so the two compare directly, in
tests/test_pallas.py's band: SDF atol 2e-4 / rtol 1e-4, gradients atol 1e-3
wherever the two t* agree to 1e-4.

JAX's cold sweep on the CPU runs ONE zoom from the coarse argmin; on the TPU
(and in the port, which follows the TPU dispatch) the cold sweep is K1 with
an extra warm branch from t = 0 and the deeper branch wins.  So the port's
cold SDF is never shallower than JAX's CPU value (beyond the band) and equals
it on almost every point; the test states exactly that."""

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
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.sweep import pallas_zoom as jpallas_zoom
from isdf_tpu.sweep.sweep_sdf import sweep_sdf as jsweep_sdf
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_warm as jsweep_sdf_warm

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import backend
from isdf_torch.shapes import make_shape
from isdf_torch.sweep import fused_zoom
from isdf_torch.sweep.fast_eval import sdf_at_time_c
from isdf_torch.sweep.sweep_sdf import (sweep_sdf, sweep_sdf_warm,
                                        traj_states)

F32 = torch.float32
D_ATOL, D_RTOL, G_ATOL, T_AGREE = 2e-4, 1e-4, 1e-3, 1e-4
CONF = dict(vmax=5.0, omgmax=5.0, thetamax=1.5, safety_hor=0.4)
SHAPES = {
    "RoundedCone": (0.0, 0.0, 0.0, 120.0, 0.0, 0.0),   # posed, as in demo 1
    "Ball": None,
    "CappedCone": None,
    "CSG": None,
}


def _case(name, seed=0, N=4, P=128):
    kw = dict(CONF)
    if SHAPES[name] is not None:
        kw["poly_params"] = SHAPES[name]
    rng = np.random.default_rng(seed)
    q = (np.linspace(1, 7, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    T = rng.uniform(1.2, 2.2, size=N)
    tail = np.zeros((3, 3))
    tail[:, 0] = [8.0, 2.0, 1.0]
    pts = rng.uniform(-1, 9, size=(P, 3))
    tw = rng.uniform(0, T.sum(), size=P)
    f = lambda a: jnp.asarray(a, jnp.float32)
    jtraj = JPolyTraj(f(T), jminco.solve(f(q), f(T), jnp.zeros((3, 3),
                                         jnp.float32), f(tail)))
    g = lambda a: torch.as_tensor(a, dtype=F32)
    ttraj = PolyTraj(g(T), minco.solve(g(q), g(T), torch.zeros(3, 3,
                                       dtype=F32), g(tail)))
    jc, tc = JConfig(**kw), Config(**kw)
    return dict(
        j=(jmake_shape(name, jc), jtraj, jfl.FlatParams.from_config(jc)),
        t=(make_shape(name, tc), ttraj, fl.FlatParams.from_config(tc)),
        pts=pts, tw=tw, q=q, T=T, tail=tail, jconf=jc, tconf=tc)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_warm_sweep_matches_jax(name):
    c = _case(name)
    s_j, t_j, g_j = (np.asarray(a) for a in jsweep_sdf_warm(
        *c["j"], jnp.asarray(c["pts"], jnp.float32),
        jnp.asarray(c["tw"], jnp.float32), coarse_n=32, refine_rounds=8))
    shape, traj, params = c["t"]
    pts = torch.as_tensor(c["pts"], dtype=F32)
    tw = torch.as_tensor(c["tw"], dtype=F32)

    # the kernel's plain version, on the pose table the sweep builds
    ts = torch.linspace(0.0, 1.0, 32, dtype=F32) * traj.total_duration
    xs, Rs = traj_states(traj, params, ts)
    pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1)
    starts = torch.cumsum(traj.durations, 0) - traj.durations
    t_r, d_r, g_r = (a.numpy() for a in fused_zoom.sweep_warm_fused_ref(
        shape, params, pts, tw, pose, starts, traj.durations, traj.coeffs,
        coarse_n=32, rounds=8))
    np.testing.assert_allclose(d_r, s_j, atol=D_ATOL, rtol=D_RTOL)
    ok = np.abs(t_r - t_j) < T_AGREE
    assert ok.mean() > 0.9
    np.testing.assert_allclose(g_r[ok], g_j[ok], atol=G_ATOL)

    before = fused_zoom.LAUNCHES
    s_t, t_t, g_t = (a.detach().numpy() for a in sweep_sdf_warm(
        shape, traj, params, pts, tw, coarse_n=32, refine_rounds=8,
        device="cpu"))
    assert fused_zoom.LAUNCHES == before      # CPU tensors: the plain version
    np.testing.assert_allclose(s_t, s_j, atol=D_ATOL, rtol=D_RTOL)
    ok = np.abs(t_t - t_j) < T_AGREE
    assert ok.mean() > 0.9
    np.testing.assert_allclose(g_t[ok], g_j[ok], atol=G_ATOL)


@pytest.mark.parametrize("name", ["RoundedCone", "CappedCone"])
def test_cold_sweep_follows_tpu_dispatch(name):
    c = _case(name, seed=1)
    s_j = np.asarray(jsweep_sdf(*c["j"], jnp.asarray(c["pts"], jnp.float32),
                                coarse_n=32, refine_rounds=8)[0])
    s_t = sweep_sdf(*c["t"], torch.as_tensor(c["pts"], dtype=F32),
                    coarse_n=32, refine_rounds=8, device="cpu")[0]
    s_t = s_t.detach().numpy()
    band = D_ATOL + D_RTOL * np.abs(s_j)
    assert np.all(s_t <= s_j + band)
    assert np.mean(np.abs(s_t - s_j) <= band) >= 0.95


def test_swept_penalty_gradient_matches_jax():
    """The penalty's gradient through the frozen-t* re-evaluation, in
    float64: in float32 t* is only determined to ~1e-5 at a smooth minimum
    (the SDF moves by less than an ulp there), and near the path the
    gradient in x turns by ~0.005 over that span."""
    N = 4
    rng = np.random.default_rng(2)
    q = (np.linspace(1, 7, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    x = np.concatenate([rng.normal(scale=0.2, size=N), q.ravel()])
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    tail[:, 0] = [8.0, 2.0, 1.0]
    pts = rng.uniform(0.5, 5.5, size=(96, 3))       # close to the path
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    tw = rng.uniform(0.0, 3.0, size=len(pts))
    jc, tc = JConfig(**CONF), Config(**CONF)
    js, ts_ = jmake_shape("Ball", jc), make_shape("Ball", tc)
    jp, tp = jfl.FlatParams.from_config(jc), fl.FlatParams.from_config(tc)
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    g64 = lambda a: torch.as_tensor(a, dtype=torch.float64)

    # the frozen-t* gradient jumps where t* changes side (between two local
    # minima of equal depth, or across a piece junction, where ∂pos(t)/∂T_j
    # at fixed t differs on the two sides): hold the chain on the points
    # whose t* the two sweeps agree on, off the junctions
    jtraj, _, _ = jbackend.build_traj(f64(x), N, f64(head), f64(tail))
    t_j = np.asarray(jsweep_sdf_warm(js, jtraj, jp, f64(pts), f64(tw),
                                     coarse_n=32, refine_rounds=8)[1])
    ttraj, _, _ = backend.build_traj(g64(x), N, g64(head), g64(tail))
    t_t = sweep_sdf_warm(ts_, ttraj, tp, g64(pts), g64(tw), coarse_n=32,
                         refine_rounds=8, device="cpu")[1].numpy()
    junctions = np.cumsum(ttraj.durations.numpy())[:-1]
    off = np.abs(t_t[:, None] - junctions[None, :]).min(axis=1) > 1e-3
    agree = np.abs(t_j - t_t) < T_AGREE
    assert agree.mean() > 0.9 and off.mean() > 0.8
    mask &= agree & off

    jw = jbackend.BackendWeights.from_config(jc)

    def jcost(x):
        traj, _, _ = jbackend.build_traj(x, N, f64(head), f64(tail))
        return jbackend.swept_penalty(js, traj, jp, jw, f64(pts),
                                      jnp.asarray(mask), f64(tw), 32, 8)[0]

    fj, gj = jax.value_and_grad(jcost)(f64(x))
    xt = g64(x).requires_grad_(True)
    traj, _, _ = backend.build_traj(xt, N, g64(head), g64(tail))
    ft, _ = backend.swept_penalty(
        ts_, traj, tp, backend.BackendWeights.from_config(tc), g64(pts),
        torch.as_tensor(mask), g64(tw), 32, 8)
    (gt,) = torch.autograd.grad(ft, xt)
    assert float(fj) > 1.0                       # the penalty is active
    np.testing.assert_allclose(float(ft.detach()), float(fj), rtol=1e-9)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj,
                               atol=1e-6 * np.abs(gj).max(), rtol=1e-6)


def test_cuda_entry_points_refuse_cpu_fallback(monkeypatch):
    c = _case("Ball", P=8)
    shape, traj, params = c["t"]
    pts = torch.as_tensor(c["pts"], dtype=F32)
    # CPU tensors with CUDA requested: no card (RuntimeError) or tensors on
    # the wrong device (ValueError) — never a quiet run on the CPU
    with pytest.raises((RuntimeError, ValueError)):
        sweep_sdf_warm(shape, traj, params, pts, torch.zeros(8),
                       device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):        # device=None means the card
        sweep_sdf(shape, traj, params, pts)


# ---------------------------------------------------------------------------
# K2: the scenario-batched sweep

def _batch_case(name, B=3, N=4, P=48, seed=4):
    """B scenarios with their own trajectories, durations and points."""
    cases = [_case(name, seed=seed + b, N=N, P=P) for b in range(B)]
    shape, _, params = cases[0]["t"]
    trajs = [c["t"][1] for c in cases]
    traj = PolyTraj(torch.stack([t.durations for t in trajs]),
                    torch.stack([t.coeffs for t in trajs]))
    pts = torch.as_tensor(np.stack([c["pts"] for c in cases]), dtype=F32)
    tw = torch.as_tensor(np.stack([c["tw"] for c in cases]), dtype=F32)
    return cases, shape, params, trajs, traj, pts, tw


def _tables(traj, params, coarse_n):
    ts = torch.linspace(0.0, 1.0, coarse_n, dtype=F32) \
        * traj.total_duration[..., None]
    xs, Rs = traj_states(traj, params, ts)
    pose = torch.cat([xs, Rs.flatten(-2)], dim=-1)
    starts = torch.cumsum(traj.durations, -1) - traj.durations
    return pose, starts


@pytest.mark.parametrize("name", ["CappedCone", "CSG"])
def test_batched_ref_equals_per_scenario_ref(name):
    """K2's plain version is K1's on each scenario: exact.  Through
    sweep_sdf_warm the batched pose table must be each scenario's own."""
    _, shape, params, trajs, traj, pts, tw = _batch_case(name)
    pose, starts = _tables(traj, params, 32)
    before = fused_zoom.LAUNCHES_BATCHED
    out = fused_zoom.sweep_warm_fused_batched(
        shape, params, pts, tw, pose, starts, traj.durations, traj.coeffs,
        coarse_n=32, rounds=8)
    assert fused_zoom.LAUNCHES_BATCHED == before     # CPU: the plain version
    assert out[0].shape == (3, 48) and out[2].shape == (3, 48, 3)
    s_b, t_b, g_b = sweep_sdf_warm(shape, traj, params, pts, tw, coarse_n=32,
                                   refine_rounds=8, device="cpu")
    for b, one in enumerate(trajs):
        pose1, starts1 = _tables(one, params, 32)
        assert torch.equal(pose[b], pose1)
        ref = fused_zoom.sweep_warm_fused_ref(
            shape, params, pts[b], tw[b], pose1, starts1, one.durations,
            one.coeffs, coarse_n=32, rounds=8)
        for a, r in zip(out, ref):
            assert torch.equal(a[b], r)
        s1, t1, g1 = sweep_sdf_warm(shape, one, params, pts[b], tw[b],
                                    coarse_n=32, refine_rounds=8,
                                    device="cpu")
        assert torch.equal(t_b[b], t1) and torch.equal(g_b[b], g1)
        torch.testing.assert_close(s_b[b], s1, rtol=1e-6, atol=1e-6)


def test_batched_warm_sweep_matches_jax_vmap():
    """jax.vmap of sweep_sdf_warm over scenarios (the route to K2 on the
    TPU; its XLA path on the CPU) in the band of the single sweep."""
    cases, shape, params, _, traj, pts, tw = _batch_case("CappedCone")
    jshape, _, jparams = cases[0]["j"]
    jT = jnp.stack([c["j"][1].durations for c in cases])
    jC = jnp.stack([c["j"][1].coeffs for c in cases])

    def one(T, C, p, t):
        return jsweep_sdf_warm(jshape, JPolyTraj(T, C), jparams, p, t,
                               coarse_n=32, refine_rounds=8)

    s_j, t_j, g_j = (np.asarray(a) for a in jax.vmap(one)(
        jT, jC, jnp.asarray(pts.numpy()), jnp.asarray(tw.numpy())))
    s_t, t_t, g_t = (a.detach().numpy() for a in sweep_sdf_warm(
        shape, traj, params, pts, tw, coarse_n=32, refine_rounds=8,
        device="cpu"))
    np.testing.assert_allclose(s_t, s_j, atol=D_ATOL, rtol=D_RTOL)
    ok = np.abs(t_t - t_j) < T_AGREE
    assert ok.mean() > 0.9
    np.testing.assert_allclose(g_t[ok], g_j[ok], atol=G_ATOL)


# ---------------------------------------------------------------------------
# K4: the plateau zoom alone

def _zoom_case(name, seed=6, P=96):
    c = _case(name, seed=seed, P=P)
    shape, traj, params = c["t"]
    rng = np.random.default_rng(seed)
    total = float(traj.total_duration)
    pts = torch.as_tensor(c["pts"], dtype=F32)
    t0 = torch.as_tensor(rng.uniform(-0.2, 1.1, size=P) * total, dtype=F32)
    w0 = torch.as_tensor(rng.uniform(0.05, 1.0, size=P), dtype=F32)
    starts = torch.cumsum(traj.durations, 0) - traj.durations
    return c, shape, traj, params, pts, t0, w0, starts


@pytest.mark.parametrize("name", ["Ball", "CappedCone"])
def test_zoom_refine_is_the_sweep_kernels_zoom(name):
    """K1's plain version picks between two zooms; K4's plain version run
    from K1's two seeds gives those two branches, so t* of the sweep is one
    of them, the deeper one, on every point (exact)."""
    c, shape, traj, params, pts, _, _, starts = _zoom_case(name)
    P, coarse_n = pts.shape[0], 32
    pose, _ = _tables(traj, params, coarse_n)
    tw = torch.as_tensor(c["tw"], dtype=F32)
    args = (starts, traj.durations, traj.coeffs)
    t_s, d_s, _ = fused_zoom.sweep_warm_fused_ref(
        shape, params, pts, tw, pose, *args, coarse_n=coarse_n, rounds=8)
    total = traj.total_duration
    step = total / torch.full_like(total, coarse_n - 1)
    # the coarse seed in the kernel's scan order (first minimum by row r =
    # j mod 8, then group j // 8)
    ts = torch.arange(coarse_n, dtype=F32) * step
    pw = tuple(pts[None, :, k] for k in range(3))
    d = sdf_at_time_c(shape, traj, params, pw, ts[:, None].expand(-1, P))
    order = torch.arange(coarse_n).reshape(-1, 8).T.reshape(-1)
    seed_b = ts[order[torch.argmin(d[order], dim=0)]]
    before = fused_zoom.LAUNCHES_ZOOM
    t_a = fused_zoom.zoom_refine(shape, params, pts,
                                 torch.clamp(tw, 0.0, float(total)),
                                 torch.full((P,), 0.3), *args, rounds=8)
    t_b = fused_zoom.zoom_refine(shape, params, pts, seed_b,
                                 step.expand(P).contiguous(), *args, rounds=8)
    assert fused_zoom.LAUNCHES_ZOOM == before        # CPU: the plain version
    is_a, is_b = t_s == t_a, t_s == t_b
    assert bool((is_a | is_b).all())
    assert bool(is_a.any()) and bool((~is_a).any())   # both branches win
    pw1 = tuple(pts[:, k] for k in range(3))
    d_a = sdf_at_time_c(shape, traj, params, pw1, t_a)
    d_b = sdf_at_time_c(shape, traj, params, pw1, t_b)
    band = D_ATOL + D_RTOL * d_s.abs()
    assert bool((torch.minimum(d_a, d_b) - d_s).abs().le(band).all())


def test_zoom_refine_rejects_malformed_inputs():
    _, shape, traj, params, pts, t0, w0, starts = _zoom_case("Ball", P=8)
    args = (starts, traj.durations, traj.coeffs)
    with pytest.raises(ValueError, match="k = 8"):
        fused_zoom.zoom_refine(shape, params, pts, t0, w0, *args, k=4)
    with pytest.raises(ValueError, match="expected"):
        fused_zoom.zoom_refine(shape, params, pts, t0[:-1], w0, *args)
    with pytest.raises(ValueError, match="piece count"):
        fused_zoom.zoom_refine(shape, params, pts, t0, w0, starts[:-1],
                               traj.durations, traj.coeffs)
    assert fused_zoom.zoom_refine(shape, params, pts, t0, w0,
                                  *args).shape == (8,)


@pytest.mark.parametrize("name", ["Ball", "CappedCone"])
def test_zoom_refine_matches_pallas_interpret(name):
    """zoom_refine_ref against the TPU kernel run in interpret mode, float32:
    t* agrees to 1e-4 on ≥ 99 % of the points (a near-tie between two
    candidates can fall either way under different rounding), and the SDF at
    the two t* agrees in the sweep's band everywhere."""
    c, shape, traj, params, pts, t0, w0, starts = _zoom_case(name)
    jshape, jtraj, jparams = c["j"]
    f = lambda a: jnp.asarray(a.numpy())
    t_j = np.asarray(jpallas_zoom.zoom_refine(
        jshape, jparams, f(pts), f(t0), f(w0), f(starts),
        jtraj.durations, jtraj.coeffs, rounds=8, interpret=True))
    t_t = fused_zoom.zoom_refine_ref(shape, params, pts, t0, w0, starts,
                                     traj.durations, traj.coeffs, rounds=8)
    assert np.mean(np.abs(t_t.numpy() - t_j) < T_AGREE) >= 0.99
    pw = tuple(pts[:, k] for k in range(3))
    d_t = sdf_at_time_c(shape, traj, params, pw, t_t).numpy()
    d_j = sdf_at_time_c(shape, traj, params, pw,
                        torch.as_tensor(t_j.copy())).numpy()
    np.testing.assert_allclose(d_t, d_j, atol=D_ATOL, rtol=D_RTOL)
