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
from isdf_tpu.sweep.sweep_sdf import sweep_sdf as jsweep_sdf
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_warm as jsweep_sdf_warm

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import backend
from isdf_torch.shapes import make_shape
from isdf_torch.sweep import fused_zoom
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
