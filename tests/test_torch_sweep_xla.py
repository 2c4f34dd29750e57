"""The port's non-fused sweep (sweep/sweep_sdf.py ``_sweep_xla``) and the
helpers that came with it, against isdf_tpu on the CPU, float64.

The kernels take coarse_n in multiples of 8 and shapes with a device SDF;
every other sweep runs the JAX package's own non-fused path, which is also
what JAX runs on the CPU.  So at coarse_n = 60 both packages run one
algorithm and agree to rounding: t* within 1e-9 (measured: ≤ 5e-15), the
SDF within 1e-9 and the gradient within 1e-8 (measured: ≤ 4e-14) on
analytic shapes; on a baked float32 field the same (the field's values are
shared, only the float64 arithmetic around them runs twice).

Also here: ``sdf_at_time`` and ``sweep_sdf_dot``, ``flatness.forward_full``,
``state_on_traj`` and ``pose_on_traj`` (1e-12), a shape built by hand with
no device SDF (the non-fused path at every coarse_n, counted by
``XLA_CALLS``), ``backend.optimize`` at ``sweep_coarse_samples = 60`` (it
raised before this path existed; the whole solve against JAX's, ~50 s of
JAX compilation, is marked slow), ``load_pcd`` on ASCII and binary files,
and ``demos.DEMOS`` against the JAX package's.  The spec-less route on
CUDA tensors is held by tests/test_torch_kernels.py, which runs on the
card without JAX."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu import demos as jdemos
from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.opt import backend as jbackend
from isdf_tpu.shapes import gridsdf as jgridsdf
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.sweep.sweep_sdf import sdf_at_time as jsdf_at_time
from isdf_tpu.sweep.sweep_sdf import sweep_sdf as jsweep_sdf
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_dot as jsweep_sdf_dot
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_warm as jsweep_sdf_warm
from isdf_tpu.world.pcd import load_pcd as jload_pcd

from isdf_torch import demos
from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import backend
from isdf_torch.shapes import Shape, grid_shape, make_shape
from isdf_torch.sweep import fused_zoom, grid_zoom, sdf_at_time
from isdf_torch.world.pcd import load_pcd

from test_torch_lmbm import SCENE, small_scene

ss = importlib.import_module("isdf_torch.sweep.sweep_sdf")
F64 = torch.float64
CONF = dict(vmax=5.0, omgmax=5.0, thetamax=1.5, safety_hor=0.4)
COARSE, ROUNDS = 60, 8
T_TOL, D_TOL, G_TOL = 1e-9, 1e-9, 1e-8


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _traj(seed=0, N=4):
    """A trajectory, the same float64 coefficients in both packages."""
    rng = np.random.default_rng(seed)
    q = (np.linspace(1, 7, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    T = rng.uniform(1.2, 2.2, size=N)
    tail = np.zeros((3, 3))
    tail[:, 0] = [8.0, 2.0, 1.0]
    c = minco.solve(_t(q), _t(T), torch.zeros(3, 3, dtype=F64), _t(tail))
    return (JPolyTraj(jnp.asarray(T), jnp.asarray(c.numpy())),
            PolyTraj(_t(T), c))


def _points(seed, P=96, lo=-1.0, hi=9.0):
    rng = np.random.default_rng(100 + seed)
    return rng.uniform(lo, hi, size=(P, 3))


def _shapes(name):
    kw = dict(CONF)
    if name == "RoundedCone":
        kw["poly_params"] = (0.0, 0.0, 0.0, 120.0, 0.0, 0.0)
    jc, tc = JConfig(**kw), Config(**kw)
    return (jmake_shape(name, jc), jfl.FlatParams.from_config(jc),
            make_shape(name, tc), fl.FlatParams.from_config(tc))


def _torus_shapes(n=24, res=0.1):
    origin = np.full(3, -1.2)
    ii = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), axis=-1)
    p = origin + ii * res
    xy = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.6
    field = (np.sqrt(xy ** 2 + p[..., 2] ** 2) - 0.25).astype(np.float32)
    return (jgridsdf.grid_shape("torus", field, origin, res),
            jfl.FlatParams(),
            grid_shape("torus", field, origin, res, device="cpu"),
            fl.FlatParams())


def _assert_close(port, jax_out):
    s_t, t_t, g_t = (a.detach().numpy() for a in port)
    s_j, t_j, g_j = (np.asarray(a) for a in jax_out)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=T_TOL)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=D_TOL)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=G_TOL)


@pytest.mark.parametrize("name", ["RoundedCone", "torus"])
def test_non_fused_sweeps_match_jax(name):
    js, jp, ts, tp = _torus_shapes() if name == "torus" else _shapes(name)
    jtraj, ttraj = _traj()
    pts = _points(0, lo=-1.0 if name != "torus" else 0.0)
    tw = np.random.default_rng(1).uniform(0, float(ttraj.total_duration),
                                          size=len(pts))
    before = (ss.XLA_CALLS, fused_zoom.LAUNCHES, grid_zoom.LAUNCHES_GRID)
    warm = ss.sweep_sdf_warm(ts, ttraj, tp, _t(pts), _t(tw), coarse_n=COARSE,
                             refine_rounds=ROUNDS, device="cpu")
    cold = ss.sweep_sdf(ts, ttraj, tp, _t(pts), coarse_n=COARSE,
                        refine_rounds=ROUNDS, device="cpu")
    assert (ss.XLA_CALLS, fused_zoom.LAUNCHES, grid_zoom.LAUNCHES_GRID) == (
        before[0] + 2,) + before[1:]
    _assert_close(warm, jsweep_sdf_warm(
        js, jtraj, jp, jnp.asarray(pts), jnp.asarray(tw), coarse_n=COARSE,
        refine_rounds=ROUNDS))
    _assert_close(cold, jsweep_sdf(js, jtraj, jp, jnp.asarray(pts),
                                   coarse_n=COARSE, refine_rounds=ROUNDS))
    # the value is differentiable in the points at the frozen t*
    p = _t(pts).requires_grad_(True)
    s, _, _ = ss.sweep_sdf_warm(ts, ttraj, tp, p, _t(tw), coarse_n=COARSE,
                                refine_rounds=ROUNDS, device="cpu")
    (gp,) = torch.autograd.grad(s.sum(), p)
    assert bool(torch.isfinite(gp).all()) and float(gp.abs().max()) > 0


def test_batched_non_fused_sweep_matches_jax_per_scenario():
    js, jp, ts, tp = _shapes("RoundedCone")
    pairs = [_traj(seed=s) for s in (0, 3)]
    batch = PolyTraj(torch.stack([p[1].durations for p in pairs]),
                     torch.stack([p[1].coeffs for p in pairs]))
    pts = np.stack([_points(s) for s in (0, 3)])
    rng = np.random.default_rng(2)
    tw = np.stack([rng.uniform(0, float(p[1].total_duration), size=96)
                   for p in pairs])
    warm = ss.sweep_sdf_warm(ts, batch, tp, _t(pts), _t(tw),
                             coarse_n=COARSE, refine_rounds=ROUNDS,
                             device="cpu")
    cold = ss.sweep_sdf(ts, batch, tp, _t(pts), coarse_n=COARSE,
                        refine_rounds=ROUNDS, device="cpu")
    for b, (jtraj, _) in enumerate(pairs):
        _assert_close([a[b] for a in warm], jsweep_sdf_warm(
            js, jtraj, jp, jnp.asarray(pts[b]), jnp.asarray(tw[b]),
            coarse_n=COARSE, refine_rounds=ROUNDS))
        _assert_close([a[b] for a in cold], jsweep_sdf(
            js, jtraj, jp, jnp.asarray(pts[b]), coarse_n=COARSE,
            refine_rounds=ROUNDS))


def test_shape_without_device_sdf_takes_the_non_fused_path():
    """A hand-built analytic shape: the kernels cannot compile it, so it
    sweeps through the non-fused path even at coarse_n % 8 == 0 (JAX on
    the CPU runs that path for every analytic shape)."""
    js, jp, ball, tp = _shapes("Ball")
    bare = Shape("HandBuilt", ball.sdf, ball.bounds, sdf3=ball.sdf3)
    assert ss.kernel_ok(ball, 64) and not ss.kernel_ok(bare, 64)
    assert not ss.kernel_ok(ball, COARSE)
    jtraj, ttraj = _traj(seed=4)
    pts = _points(4)
    before = ss.XLA_CALLS
    out = ss.sweep_sdf(bare, ttraj, tp, _t(pts), coarse_n=64,
                       refine_rounds=ROUNDS, device="cpu")
    assert ss.XLA_CALLS == before + 1
    _assert_close(out, jsweep_sdf(js, jtraj, jp, jnp.asarray(pts),
                                  coarse_n=64, refine_rounds=ROUNDS))


def test_sdf_at_time_and_its_time_derivative_match_jax():
    js, jp, ts, tp = _shapes("RoundedCone")
    jtraj, ttraj = _traj(seed=5)
    pts = _points(5, P=16)
    t = np.random.default_rng(6).uniform(0, float(ttraj.total_duration), 16)
    jval, jdot = jax.jit(lambda p, s: (
        jsdf_at_time(js, jtraj, jp, p, s),
        jsweep_sdf_dot(js, jtraj, jp, p, s)))(jnp.asarray(pts),
                                              jnp.asarray(t))
    np.testing.assert_allclose(
        sdf_at_time(ts, ttraj, tp, _t(pts), _t(t)).detach().numpy(),
        np.asarray(jval), rtol=0, atol=1e-12)
    dot = ss.sweep_sdf_dot(ts, ttraj, tp, _t(pts), _t(t))
    np.testing.assert_allclose(dot.numpy(), np.asarray(jdot), rtol=1e-10,
                               atol=1e-10)


def test_flatness_helpers_match_jax():
    rng = np.random.default_rng(8)
    K = 32
    vel, acc, jer = (rng.normal(size=(K, 3)) for _ in range(3))
    psi, dpsi = rng.uniform(-3, 3, K), rng.normal(size=K)
    jp, tp = jfl.FlatParams(), fl.FlatParams()
    j = jfl.forward_full(*(jnp.asarray(a) for a in (vel, acc, jer, psi,
                                                    dpsi)), jp)
    t = fl.forward_full(*(_t(a) for a in (vel, acc, jer, psi, dpsi)), tp)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    jtraj, ttraj = _traj(seed=9)
    ts = np.linspace(0.0, float(ttraj.total_duration), 17)
    for jf, tf in ((jfl.state_on_traj, fl.state_on_traj),
                   (jfl.pose_on_traj, fl.pose_on_traj)):
        jo = jax.jit(jax.vmap(lambda s: jf(jtraj, s, jp)))(jnp.asarray(ts))
        to = tf(ttraj, _t(ts), tp)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)


def test_backend_at_coarse_60_solves():
    """C1: a coarse_n that is not a multiple of 8 made the port's back end
    raise at its first evaluation (the kernels' argument check); now every
    evaluation sweeps through the non-fused path, whose sweeps equal JAX's
    above, and the solve completes."""
    head, tail, q0, T0, pts, mask = small_scene(P=24)
    tc = Config(**SCENE)
    before = ss.XLA_CALLS
    traj, res = backend.optimize(make_shape("Ball", tc), tc, head, tail, q0,
                                 T0, pts, mask, max_iters=3, device="cpu",
                                 dtype=F64)
    assert res.n_iters == 3 and ss.XLA_CALLS - before == res.n_evals
    assert float(res.history[2]) < float(res.history[0])
    assert bool(torch.isfinite(traj.coeffs).all())


@pytest.mark.slow
def test_backend_solve_at_coarse_60_matches_jax(record_property):
    """The whole L-BFGS solve at coarse_n = 60 in both packages (a JAX
    solve compiles for ~50 s on the CPU): the same iterations and
    evaluations, x within 1e-6 (measured on a like scene: 2.5e-11)."""
    head, tail, q0, T0, pts, mask = small_scene()
    jc, tc = JConfig(**SCENE), Config(**SCENE)
    _, rj = jbackend.optimize(
        jmake_shape("Ball", jc), jc, *(jnp.asarray(a) for a in (
            head, tail, q0, T0, pts, mask)), max_iters=20)
    _, rt = backend.optimize(make_shape("Ball", tc), tc, head, tail, q0, T0,
                             pts, mask, max_iters=20, device="cpu",
                             dtype=F64)
    record_property("iters_evals", (rt.n_iters, rt.n_evals))
    record_property("x_gap", float(np.abs(rt.x.numpy() - np.asarray(rj.x))
                                   .max()))
    assert (rt.n_iters, rt.n_evals) == (int(rj.n_iters), int(rj.n_evals))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-6)


def _write_pcd(path, pts, binary):
    head = ("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
            "TYPE F F F F\nCOUNT 1 1 1 1\n"
            f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {len(pts)}\n")
    data = np.column_stack([pts, np.arange(len(pts))]).astype(np.float32)
    with open(path, "wb") as f:
        f.write(("# .PCD v0.7\n" + head).encode())
        if binary:
            f.write(b"DATA binary\n")
            f.write(data.tobytes())
        else:
            f.write(b"DATA ascii\n")
            np.savetxt(f, data, fmt="%.6f")


@pytest.mark.parametrize("binary", [False, True])
def test_load_pcd_matches_jax(tmp_path, binary):
    pts = np.random.default_rng(11).uniform(-5, 5, size=(37, 3))
    path = str(tmp_path / "map.pcd")
    _write_pcd(path, pts, binary)
    got = load_pcd(path)
    assert got.shape == (37, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jload_pcd(path))
    np.testing.assert_allclose(got, pts, atol=1e-5)


def test_demos_equal_jax():
    assert sorted(demos.DEMOS) == sorted(jdemos.DEMOS)
    for k, spec in demos.DEMOS.items():
        jspec = jdemos.DEMOS[k]
        for f in ("demo_id", "pcd", "map_id", "start", "goal", "planar",
                  "shape_name", "planar_map", "yaw_opt"):
            assert getattr(spec, f) == getattr(jspec, f), (k, f)
        tc, jc = dict(vars(spec.config)), dict(vars(jspec.config))
        # asset paths sit under each package's reference checkout (the
        # port's paths stay relative to it while it is unset)
        rel = [os.path.relpath(c.pop("inputdata"), root or os.curdir)
               if c.get("inputdata") else c.pop("inputdata")
            for c, root in ((tc, demos.REFERENCE_ROOT),
                            (jc, jdemos.REFERENCE_ROOT))]
        assert rel[0] == rel[1] and tc == jc, k


def test_demos_without_assets_raise_like_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(demos, "REFERENCE_ROOT", "")
    with pytest.raises(FileNotFoundError):
        demos.load_demo_points(demos.DEMOS[1])
    with pytest.raises(FileNotFoundError):
        demos.run_demo(1, device="cpu")
    monkeypatch.setattr(demos, "REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setattr(demos, "_PM", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        demos.load_demo_points(demos.DEMOS[1])
    pts = demos.load_demo_points(demos.DEMOS[6], res=0.8)
    assert pts.shape[1] == 3 and len(pts) > 100
