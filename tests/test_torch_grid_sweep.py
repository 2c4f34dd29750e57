"""isdf_torch's mesh-robot sweep against isdf_tpu, on the CPU: the trilinear
field, the device field of a grid shape, K3's plain version and the grid
branches of sweep_sdf.

On the CPU JAX's warm sweep of a grid shape takes its XLA path (the dual k=8
zoom on the full float32 field), not K3's algorithm, so the plain version is
held to it in tests/test_pallas.py's bands for the TPU kernel: SDF within
1.5 % + 0.015, the true depth at the port's t* at most 6e-2 above the depth
at JAX's t*, and the gradient within 0.1 wherever the two t* agree to 1e-3.
The slow tests hold the plain version against the TPU kernel itself, run in
interpret mode."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import minco as jminco
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.shapes import gridsdf as jgridsdf
from isdf_tpu.sweep import fast_eval as jfast_eval
from isdf_tpu.sweep import pallas_grid_zoom as jpgz
from isdf_tpu.sweep.sweep_sdf import sdf_at_time as jsdf_at_time
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_warm as jsweep_sdf_warm

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.shapes import gridsdf, grid_shape, mesh_shape, \
    shape_from_config
from isdf_torch.sweep import grid_zoom
from isdf_torch.sweep.fast_eval import sdf_at_time_c
from isdf_torch.sweep.sweep_sdf import sweep_sdf, sweep_sdf_warm

# the module (the package exports its function under the same name)
ss = importlib.import_module("isdf_torch.sweep.sweep_sdf")
F32, F64 = torch.float32, torch.float64
CONF = dict(vmax=5.0, omgmax=5.0, thetamax=1.5, safety_hor=0.4)
D_BAND_REL, D_BAND_ABS, REGRET, G_ATOL, T_NEAR = 0.015, 0.015, 6e-2, 0.1, 1e-3


def _torus_field(n=24, res=0.1):
    """tests/test_pallas.py's field: a torus (ring 0.6, tube 0.25) on an n³
    grid from -1.2, in float32 as a baked field is stored."""
    origin = np.full(3, -1.2)
    ii = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), axis=-1)
    p = origin + ii * res
    xy = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.6
    field = np.sqrt(xy ** 2 + p[..., 2] ** 2) - 0.25
    return field.astype(np.float32), origin, res


def _case(dtype=F32, P=200, seed=0):
    """test_pallas.py's grid case: the torus field, N = 4 pieces, P points
    in [-1, 9]³, warm starts in [0, total]."""
    field, origin, res = _torus_field()
    rng = np.random.default_rng(seed)
    N = 4
    q = (np.linspace(1, 7, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    T = rng.uniform(1.2, 2.2, size=N)
    tail = np.zeros((3, 3))
    tail[:, 0] = [8.0, 2.0, 1.0]
    pts = rng.uniform(-1, 9, size=(P, 3))
    tw = rng.uniform(0, T.sum(), size=P)
    jdt = jnp.float32 if dtype == F32 else jnp.float64
    f = lambda a: jnp.asarray(a, jdt)
    jtraj = JPolyTraj(f(T), jminco.solve(f(q), f(T), jnp.zeros((3, 3), jdt),
                                         f(tail)))
    g = lambda a: torch.as_tensor(a, dtype=dtype)
    ttraj = PolyTraj(g(T), minco.solve(g(q), g(T), torch.zeros(3, 3,
                                       dtype=dtype), g(tail)))
    jc, tc = JConfig(**CONF), Config(**CONF)
    return dict(
        j=(jgridsdf.grid_shape("t24f", field, origin, res), jtraj,
           jfl.FlatParams.from_config(jc)),
        t=(grid_shape("t24f", field, origin, res, device="cpu"), ttraj,
           fl.FlatParams.from_config(tc)),
        pts=pts, tw=tw, f=f, g=g)


def _kernel_args(traj, g, pts, tw):
    durs = traj.durations
    return (g(pts), g(tw), torch.cumsum(durs, 0) - durs, durs, traj.coeffs)


# ---------------------------------------------------------------------------
# the field

def test_interp3_matches_jax():
    """Value and autograd gradient of the trilinear field with its outside
    fallback, inside and outside the grid box, float64: 1e-12."""
    field, origin, res = _torus_field()
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.uniform(-1.2, 1.1, size=(300, 3)),     # inside
                        rng.uniform(-3.0, 3.0, size=(300, 3))])    # around
    jfield = jnp.asarray(field, jnp.float64)
    jf = lambda x, y, z: jnp.sum(jgridsdf._interp3(jfield, origin, res,
                                                   x, y, z))
    cols = [jnp.asarray(p[:, i]) for i in range(3)]
    vj = np.asarray(jgridsdf._interp3(jfield, origin, res, *cols))
    gj = np.stack([np.asarray(a) for a in jax.grad(jf, argnums=(0, 1, 2))(
        *cols)], axis=-1)
    q = torch.tensor(p, dtype=F64, requires_grad=True)
    vt = gridsdf._interp3(torch.as_tensor(field, dtype=F64), origin, res,
                          q[:, 0], q[:, 1], q[:, 2])
    (gt,) = torch.autograd.grad(vt.sum(), q)
    np.testing.assert_allclose(vt.detach().numpy(), vj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-12)
    assert (np.abs(p) > 1.2).any(axis=1).sum() > 100      # outside points


def test_grid_field_matches_grid_sweep_inputs():
    """GridField against the JAX wrapper's inputs, with its z-major padding
    and bf16 cast undone: the field and the pooled twin within bf16's
    rounding (2⁻⁸ of the value), the twin exactly the 2×2×2 min of the
    edge-padded field, the dimensions equal and the ten geometry numbers
    equal in float32."""
    rng = np.random.default_rng(2)
    field = rng.normal(size=(25, 18, 13)).astype(np.float32)   # odd dims
    origin, res = np.array([-1.3, 0.2, -0.45]), 0.07
    grid = grid_zoom.GridField.build(field, origin, res, "cpu")
    pg = jgridsdf.grid_shape("g", field, origin, res).grid
    dims, dims_c, fz, fzc, geo = jpgz.grid_sweep_inputs(pg)

    def unpad(z, d6):
        nx, ny, nz, nxp, nyp, nzp = d6
        a = np.asarray(z, np.float32).reshape(nzp, nxp, nyp)
        return a[:nz, :nx, :ny].transpose(1, 2, 0)

    assert grid.dims == tuple(dims[:3])
    assert grid.pooled_dims == tuple(dims_c[:3])
    for mine, theirs in ((grid.field, unpad(fz, dims)),
                         (grid.pooled, unpad(fzc, dims_c))):
        mine = mine.numpy()
        assert (np.abs(mine - theirs) <= 2.0 ** -8 * np.abs(mine)).all()
    fe = np.pad(field, [(0, n % 2) for n in field.shape], mode="edge")
    ref = fe.reshape(13, 2, 9, 2, 7, 2).min(axis=(1, 3, 5))
    np.testing.assert_array_equal(grid.pooled.numpy(), ref)
    np.testing.assert_array_equal(np.asarray(grid.geo, np.float32), geo)


# ---------------------------------------------------------------------------
# K3's plain version

def test_grid_sweep_ref_matches_jax_warm_sweep():
    """grid_sweep_warm_fused_ref against JAX's warm sweep (its XLA path on
    the CPU), float32, in tests/test_pallas.py's bands for K3."""
    c = _case()
    jshape, jtraj, jparams = c["j"]
    shape, traj, params = c["t"]
    f, pts = c["f"], c["pts"]
    s_j, t_j, g_j = (np.asarray(a) for a in jsweep_sdf_warm(
        jshape, jtraj, jparams, f(pts), f(c["tw"]), coarse_n=32,
        refine_rounds=8, use_pallas=False))
    t_t, d_t, g_t = (a.numpy() for a in grid_zoom.grid_sweep_warm_fused(
        shape.grid, params, *_kernel_args(traj, c["g"], pts, c["tw"]),
        coarse_n=32, rounds=8))
    assert (np.abs(d_t - s_j) <= D_BAND_REL * np.abs(s_j) + D_BAND_ABS).all()
    d_at_t = np.asarray(jsdf_at_time(jshape, jtraj, jparams, f(pts),
                                     f(t_t)))
    d_at_j = np.asarray(jsdf_at_time(jshape, jtraj, jparams, f(pts),
                                     f(t_j)))
    assert (d_at_t <= d_at_j + REGRET).all()
    # d* is the trilinear value at the port's own t* (a product with 1/res
    # where JAX divides by res: a few ulps)
    np.testing.assert_allclose(d_t, d_at_t, atol=1e-5)
    near = np.abs(t_t - t_j) < T_NEAR
    assert near.sum() >= 20
    np.testing.assert_allclose(g_t[near], g_j[near], atol=G_ATOL)


def test_warm_entry_point_returns_the_kernel_results():
    """sweep_sdf_warm on a grid shape: one wrapper call; t*, the gradient
    and the (linearised) value equal the plain version's t*, g* and d*
    bit for bit."""
    c = _case(P=64)
    shape, traj, params = c["t"]
    args = _kernel_args(traj, c["g"], c["pts"], c["tw"])
    t_r, d_r, g_r = grid_zoom.grid_sweep_warm_fused(
        shape.grid, params, *args, coarse_n=32, rounds=8)
    s, t, g = sweep_sdf_warm(shape, traj, params, args[0], args[1],
                             coarse_n=32, refine_rounds=8, device="cpu")
    assert torch.equal(t, t_r) and torch.equal(g, g_r)
    assert torch.equal(s, d_r)


def test_cold_sweep_reevaluates_the_field_at_kernel_t():
    """sweep_sdf on a grid shape (the audit): t* from K3 seeded at t = 0
    with window 0.3, the value the trilinear field at t* and the gradient
    its autograd, as the TPU dispatch computes them."""
    c = _case(P=64)
    shape, traj, params = c["t"]
    pts = c["g"](c["pts"])
    t_r, _, _ = grid_zoom.grid_sweep_warm_fused(
        shape.grid, params, *_kernel_args(traj, c["g"], c["pts"],
                                          np.zeros(64)),
        coarse_n=32, rounds=8, warm_window=0.3)
    s, t, g = sweep_sdf(shape, traj, params, pts, coarse_n=32,
                        refine_rounds=8, device="cpu")
    assert torch.equal(t, t_r)
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    assert torch.equal(s, sdf_at_time_c(shape, traj, params, pw, t))
    assert torch.equal(g, ss._grad_prel(shape, traj, params, pts, t))


@pytest.mark.parametrize("batched", [False, True])
def test_linearised_value_gradient_matches_jax_expression(monkeypatch,
                                                          batched):
    """The warm branch's value d* + g*·(p_rel(θ, t*) − p_rel*) at fixed
    (t*, d*, g*): its value is d*, and its gradient with respect to the
    coefficients and the durations equals the same expression built from
    isdf_tpu.sweep.fast_eval (sweep_sdf.py:312-319), float64, 1e-9 —
    for one trajectory and for a batch of two."""
    B = 2 if batched else 1
    cases = [_case(F64, P=48, seed=5 + b) for b in range(B)]
    rng = np.random.default_rng(9)
    fixed = [(rng.uniform(0, float(c["t"][1].total_duration), size=48),
              rng.normal(size=48), rng.normal(size=(48, 3)))
             for c in cases]
    shape, _, params = cases[0]["t"]
    jshape, _, jparams = cases[0]["j"]

    def expected(c, tstar, d0, g0):
        jtraj = c["j"][1]
        pw = tuple(jnp.asarray(c["pts"][:, i]) for i in range(3))

        def lin(coeffs, durs):
            tr = JPolyTraj(durs, coeffs)
            pos, vel, acc, _ = jfast_eval.pvaj_components(
                tr, jnp.asarray(tstar), n_orders=3)
            x3, R = jfast_eval.pose_components(pos, vel, acc, jparams)
            r = jfast_eval.rel_components(pw, x3, R)
            r0 = [jax.lax.stop_gradient(a) for a in r]
            return jnp.sum(d0 + sum(g0[:, i] * (r[i] - r0[i])
                                    for i in range(3)))

        return [np.asarray(a) for a in jax.grad(lin, argnums=(0, 1))(
            jtraj.coeffs, jtraj.durations)]

    stack = (lambda xs: torch.stack(xs)) if batched else (lambda xs: xs[0])
    coeffs = stack([c["t"][1].coeffs for c in cases]).requires_grad_(True)
    durs = stack([c["t"][1].durations for c in cases]).requires_grad_(True)
    pts = stack([torch.as_tensor(c["pts"]) for c in cases])
    out = tuple(stack([torch.as_tensor(v[i]) for v in fixed])
                for i in range(3))
    monkeypatch.setattr(ss, "_grid_kernel", lambda *a, **k: out)
    s, _, _ = sweep_sdf_warm(shape, PolyTraj(durs, coeffs), params, pts,
                             torch.zeros(pts.shape[:-1], dtype=F64),
                             device="cpu")
    assert torch.equal(s.detach(), out[1])
    gc, gd = torch.autograd.grad(s.sum(), (coeffs, durs))
    for b, c in enumerate(cases):
        ec, ed = expected(c, *fixed[b])
        mine_c = gc[b] if batched else gc
        mine_d = gd[b] if batched else gd
        np.testing.assert_allclose(mine_c.numpy(), ec, rtol=1e-9,
                                   atol=1e-9 * np.abs(ec).max())
        np.testing.assert_allclose(mine_d.numpy(), ed, rtol=1e-9,
                                   atol=1e-9 * np.abs(ed).max())


def test_batched_equals_single_scenarios():
    """The batched plain version and the batched grid branches of
    sweep_sdf_warm / sweep_sdf give every scenario exactly what its
    single-trajectory call gives."""
    cases = [_case(P=40, seed=20 + b) for b in range(3)]
    shape, _, params = cases[0]["t"]
    trajs = [c["t"][1] for c in cases]
    traj = PolyTraj(torch.stack([t.durations for t in trajs]),
                    torch.stack([t.coeffs for t in trajs]))
    pts = torch.stack([torch.as_tensor(c["pts"], dtype=F32) for c in cases])
    tw = torch.stack([torch.as_tensor(c["tw"], dtype=F32) for c in cases])
    durs = traj.durations
    kw = dict(coarse_n=32, rounds=8)
    tb, db, gb = grid_zoom.grid_sweep_warm_fused_batched_ref(
        shape.grid, params, pts, tw, torch.cumsum(durs, -1) - durs, durs,
        traj.coeffs, **kw)
    wb = sweep_sdf_warm(shape, traj, params, pts, tw, coarse_n=32,
                        refine_rounds=8, device="cpu")
    cb = sweep_sdf(shape, traj, params, pts, coarse_n=32, refine_rounds=8,
                   device="cpu")
    for b, tr in enumerate(trajs):
        t1, d1, g1 = grid_zoom.grid_sweep_warm_fused_ref(
            shape.grid, params, pts[b], tw[b], torch.cumsum(tr.durations, 0)
            - tr.durations, tr.durations, tr.coeffs, **kw)
        assert torch.equal(tb[b], t1) and torch.equal(db[b], d1)
        assert torch.equal(gb[b], g1)
        w1 = sweep_sdf_warm(shape, tr, params, pts[b], tw[b], coarse_n=32,
                            refine_rounds=8, device="cpu")
        c1 = sweep_sdf(shape, tr, params, pts[b], coarse_n=32,
                       refine_rounds=8, device="cpu")
        for batch_out, one in ((wb, w1), (cb, c1)):
            for x, y in zip(batch_out, one):
                assert torch.equal(x[b], y)


def test_wrappers_reject_malformed_inputs():
    c = _case(P=16)
    shape, traj, params = c["t"]
    args = _kernel_args(traj, c["g"], c["pts"], c["tw"])
    with pytest.raises(ValueError, match="multiple of 8"):
        grid_zoom.grid_sweep_warm_fused(shape.grid, params, *args,
                                        coarse_n=60)
    pts, tw, *rest = args
    with pytest.raises(ValueError, match="expected"):
        grid_zoom.grid_sweep_warm_fused(shape.grid, params, pts[:, :2], tw,
                                        *rest)
    with pytest.raises(ValueError, match="expected"):
        grid_zoom.grid_sweep_warm_fused_batched(shape.grid, params, *args)
    with pytest.raises(ValueError, match="at least 3"):
        grid_zoom.GridField.build(np.zeros((2, 5, 5)), np.zeros(3), 0.1,
                                  "cpu")
    before = grid_zoom.LAUNCHES_GRID
    t, d, g = grid_zoom.grid_sweep_warm_fused(shape.grid, params, *args)
    assert grid_zoom.LAUNCHES_GRID == before        # CPU: the plain version
    assert t.shape == d.shape == (16,) and g.shape == (16, 3)


def test_mesh_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """CPU tensors with the card requested, or the default device without a
    card, raise: never a quiet run on the CPU."""
    c = _case(P=8)
    shape, traj, params = c["t"]
    pts = torch.as_tensor(c["pts"], dtype=F32)
    with pytest.raises((RuntimeError, ValueError)):
        sweep_sdf_warm(shape, traj, params, pts, torch.zeros(8),
                       device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sweep_sdf(shape, traj, params, pts)
    field, origin, res = _torus_field(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        grid_shape("g", field, origin, res)
    obj = tmp_path / "cube.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_shape("tet", str(obj))
    with pytest.raises(RuntimeError, match="CUDA"):
        shape_from_config(Config(inputdata=str(obj)))


# ---------------------------------------------------------------------------
# against the TPU kernel itself, in interpret mode (slow)

def _pallas(c, tw=None, P=None):
    jshape, jtraj, jparams = c["j"]
    dims, dims_c, fz, fzc, geo = jpgz.grid_sweep_inputs(jshape.grid)
    durs = jtraj.durations
    pts = c["pts"] if P is None else c["pts"][:P]
    tw = c["tw"] if tw is None else tw
    return [np.asarray(a) for a in jpgz.grid_sweep_warm_fused(
        dims, dims_c, jparams, fz, fzc, geo, c["f"](pts), c["f"](tw),
        jnp.cumsum(durs) - durs, durs, jtraj.coeffs, coarse_n=32, rounds=8,
        interpret=True)]


@pytest.mark.slow
def test_grid_sweep_ref_matches_pallas_interpret():
    """The plain version against K3 itself (bf16 field, two-hot MXU form) in
    interpret mode, float32: the bf16 band for d*, the regret band for t*,
    and the gradient within 0.1 where the two t* agree to 1e-3."""
    c = _case()
    jshape, jtraj, jparams = c["j"]
    shape, traj, params = c["t"]
    f, pts = c["f"], c["pts"]
    t_p, d_p, g_p = _pallas(c)
    t_t, d_t, g_t = (a.numpy() for a in grid_zoom.grid_sweep_warm_fused(
        shape.grid, params, *_kernel_args(traj, c["g"], pts, c["tw"]),
        coarse_n=32, rounds=8))
    assert (np.abs(d_t - d_p) <= D_BAND_REL * np.abs(d_p) + D_BAND_ABS).all()
    d_at_t = np.asarray(jsdf_at_time(jshape, jtraj, jparams, f(pts),
                                     f(t_t)))
    d_at_p = np.asarray(jsdf_at_time(jshape, jtraj, jparams, f(pts),
                                     f(t_p)))
    assert (d_at_t <= d_at_p + REGRET).all()
    near = np.abs(t_t - t_p) < T_NEAR
    assert near.sum() >= 20
    np.testing.assert_allclose(g_t[near], g_p[near], atol=G_ATOL)


@pytest.mark.slow
def test_linearised_penalty_gradient_finite_differences():
    """The port's warm grid branch as swept_penalty differentiates it: its
    gradient predicts its own finite differences (test_pallas.py's
    calibration: the closest direction within 0.2, the median within 0.6),
    and its summed value agrees with the TPU kernel's linearised value
    (interpret mode) within 2 % + 0.5."""
    c = _case(P=64, seed=0)
    shape, traj, params = c["t"]
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-0.5, 8.5, size=(64, 3)), dtype=F32)
    tw = torch.zeros(64)

    def pen(coeffs):
        s, _, _ = sweep_sdf_warm(shape, PolyTraj(traj.durations, coeffs),
                                 params, pts, tw, coarse_n=32,
                                 refine_rounds=8, device="cpu")
        return s.sum()

    coeffs = traj.coeffs.detach().clone().requires_grad_(True)
    v = pen(coeffs)
    (g,) = torch.autograd.grad(v, coeffs)
    v = float(v.detach())
    rng2 = np.random.default_rng(7)
    h, rels = 1e-3, []
    with torch.no_grad():
        for _ in range(6):
            u = torch.as_tensor(rng2.normal(size=coeffs.shape), dtype=F32)
            u = u / torch.linalg.norm(u)
            fd = float(pen(coeffs + h * u) - pen(coeffs - h * u)) / (2 * h)
            pred = float((g * u).sum())
            rels.append(abs(fd - pred) / max(abs(fd), abs(pred), 1.0))
    rels = np.sort(rels)
    assert rels[0] < 0.2, rels
    assert np.median(rels) < 0.6, rels
    c["pts"] = pts.numpy()
    _, d_p, _ = _pallas(c, tw=np.zeros(64))
    assert abs(v - float(d_p.sum())) <= 0.02 * abs(v) + 0.5
