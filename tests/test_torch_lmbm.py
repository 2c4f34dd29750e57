"""isdf_torch's LMBM (opt/lmbm.py) against isdf_tpu's, float64 on the CPU.

* ``_aggregate3`` and ``_sr1_direction`` on random inputs: 1e-12.
* ``lbfgs._two_loop(gamma_clamp=)``: 1e-12, with the clamp active at both
  ends.
* ``lmbm.minimize`` on tests/test_lmbm.py's problems (sum-abs, MAXQ, chained
  LQ, max-abs, the smooth quadratic): the same iterations and evaluations,
  and the cost history within 1e-12 (measured: ≤ 3e-15).  Chained LQ is the
  exception: its stopping test is taken at the rounding floor near f*, so
  the count follows the last bits of the dot products (JAX's own eager and
  jitted runs of it stop at different counts).  There the histories
  agree to 1e-10 over the iterations both ran (measured 7.7e-12), the port
  reaches f* within 1e-9, and its endpoint equals JAX's within 1e-7.
* ``backend.optimize(method="lmbm")`` on a small scene with
  ``sweep_coarse_samples = 60``, so that both packages sweep through the
  same non-fused path: the same iterations and evaluations, x within 1e-5
  and the final cost within 1e-7 relative (measured on a like scene: 1.5e-6
  and 3e-9).  A JAX back-end solve compiles for ~50 s on the CPU, so this
  comparison is marked slow; the port's solve alone runs in Tier-1."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.opt import backend as jbackend
from isdf_tpu.opt import lbfgs as jlbfgs
from isdf_tpu.opt import lmbm as jlmbm
from isdf_tpu.shapes import make_shape as jmake_shape

from isdf_torch.config import Config
from isdf_torch.opt import backend, lbfgs, lmbm
from isdf_torch.shapes import make_shape

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def test_aggregate3_matches_jax():
    rng = np.random.default_rng(3)
    for n in (3, 5, 13):
        for _ in range(6):
            G = rng.normal(size=(3, n))
            b = np.abs(rng.normal(size=2))
            if rng.uniform() < 0.3:
                G[2] = G[0]                  # a singular 2Q: no interior
            j = jlmbm._aggregate3(*(jnp.asarray(v) for v in G),
                                  jnp.asarray(b[0]), jnp.asarray(b[1]))
            t = lmbm._aggregate3(*(_t(v) for v in G), _t(b[0]), _t(b[1]))
            np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(float(t[1]), float(j[1]),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_corr,head", [(0, 0), (3, 3), (8, 2), (5, 1)])
def test_sr1_direction_matches_jax(n_corr, head):
    rng = np.random.default_rng(n_corr + 10 * head)
    m, n = 8, 7
    S, Y = rng.normal(size=(m, n)), rng.normal(size=(m, n))
    g = rng.normal(size=n)
    j = jlmbm._sr1_direction(jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y),
                             jnp.zeros(m), jnp.asarray(n_corr),
                             jnp.asarray(head), m)
    t = lmbm._sr1_direction(_t(g), _t(S), _t(Y), torch.zeros(m, dtype=F64),
                            n_corr, head, m)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_two_loop_gamma_clamp_matches_jax(scale):
    """The last pair's s·y/y·y is about ``scale``: below, inside and above
    the (0.01, 100) clamp."""
    rng = np.random.default_rng(7)
    m, n, n_corr, head = 6, 5, 4, 4
    Y = rng.normal(size=(m, n))
    S = scale * Y + 0.1 * scale * rng.normal(size=(m, n))
    rho = 1.0 / np.einsum("ij,ij->i", S, Y)
    g = rng.normal(size=n)
    for clamp in (None, (0.01, 100.0)):
        j = jlbfgs._two_loop(jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y),
                             jnp.asarray(rho), jnp.asarray(n_corr),
                             jnp.asarray(head), m, gamma_clamp=clamp)
        t = lbfgs._two_loop(_t(g), _t(S), _t(Y), _t(rho), n_corr, head, m,
                            gamma_clamp=clamp)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-12)


def _chained(x, lib):
    a = -x[:-1] - x[1:]
    return lib.sum(lib.maximum(a, a + x[:-1] ** 2 + x[1:] ** 2 - 1.0))


WEIGHTS = np.array([1.0, 10.0, 100.0])
# name → (JAX f, port f, x0, minimize's keywords)
PROBLEMS = {
    "sum_abs": (lambda x: jnp.sum(jnp.abs(x - 0.3)),
                lambda x: torch.sum(torch.abs(x - 0.3)),
                [3.0, -2.0, 1.0], dict(max_iters=300)),
    "maxq": (lambda x: jnp.max(x * x), lambda x: torch.max(x * x),
             [1.0, 2.0, 3.0, 4.0, 5.0], dict(max_iters=500, tol=1e-8)),
    "max_abs": (lambda x: jnp.max(jnp.abs(x)),
                lambda x: torch.max(torch.abs(x)),
                [2.0, -1.5, 0.7], dict(max_iters=400)),
    "quadratic": (lambda x: 0.5 * jnp.sum(x * x * WEIGHTS),
                  lambda x: 0.5 * torch.sum(x * x * _t(WEIGHTS)),
                  [1.0, 1.0, 1.0], dict(max_iters=300)),
    "chained_lq": (lambda x: _chained(x, jnp), lambda x: _chained(x, torch),
                   [-0.5] * 6, dict(max_iters=500)),
}


def _jcg(f):
    def cg(x, aux):
        v, g = jax.value_and_grad(f)(x)
        return v, g, aux
    return cg


def _tcg(f):
    def cg(x, aux):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            v = f(xg)
            (g,) = torch.autograd.grad(v, xg)
        return v.detach(), g, aux
    return cg


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_minimize_matches_jax(name):
    fj, ft, x0, kw = PROBLEMS[name]
    rj = jlmbm.minimize(_jcg(fj), jnp.asarray(x0), None, **kw)
    rt = lmbm.minimize(_tcg(ft), _t(x0), None, **kw)
    hj, ht = np.asarray(rj.history), rt.history.numpy()
    if name == "chained_lq":
        both = np.isfinite(hj) & np.isfinite(ht)
        np.testing.assert_allclose(ht[both], hj[both], rtol=0, atol=1e-10)
        assert float(rt.f) < -5 * np.sqrt(2) + 1e-9
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-7)
        return
    assert (rt.n_iters, rt.n_evals) == (int(rj.n_iters), int(rj.n_evals))
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-12)
    np.testing.assert_allclose(rt.g.numpy(), np.asarray(rj.g), atol=1e-12)


SCENE = dict(integralIntervs=8, sweep_coarse_samples=60,
             sweep_refine_rounds=4, vmax=5.0, omgmax=5.0, thetamax=1.5,
             safety_hor=0.4, mem_size=8)


def small_scene(P=48, seed=0):
    """A 4-piece trajectory among P random points (tests/test_opt.py's
    monitor scene)."""
    rng = np.random.default_rng(seed)
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    tail[:, 0] = [6.0, 1.0, 0.5]
    q0 = np.linspace(1, 5, 3)[:, None] * np.array([1.0, 0.2, 0.1])
    T0 = np.full(4, 2.0)
    pts = rng.uniform(0, 6, size=(P, 3))
    return head, tail, q0, T0, pts, np.ones(P, bool)


def test_backend_lmbm_runs():
    """``backend.optimize(method="lmbm")`` on the port alone: every
    evaluation sweeps once (the non-fused path at coarse_n = 60), the cost
    falls, and every iteration is a serious or a null step."""
    head, tail, q0, T0, pts, mask = small_scene(P=24)
    tc = Config(**SCENE)
    sweeps = importlib.import_module("isdf_torch.sweep.sweep_sdf")
    before = sweeps.XLA_CALLS
    traj, res = backend.optimize(
        make_shape("Ball", tc), tc, head, tail, q0, T0, pts, mask,
        max_iters=6, method="lmbm", device="cpu", dtype=F64)
    assert sweeps.XLA_CALLS - before == res.n_evals
    assert res.stats["serious"] + res.stats["null"] == res.n_iters == 6
    assert res.stats["serious"] > 0 and float(res.f) < float(res.history[0])
    assert res.aux.shape == (len(pts),)
    assert bool(torch.isfinite(traj.coeffs).all())


@pytest.mark.slow
def test_backend_lmbm_matches_jax(record_property):
    """The whole LMBM back-end solve in both packages (a JAX solve compiles
    for ~50 s on the CPU)."""
    head, tail, q0, T0, pts, mask = small_scene()
    jc, tc = JConfig(**SCENE), Config(**SCENE)
    _, rj = jbackend.optimize(
        jmake_shape("Ball", jc), jc, *(jnp.asarray(a) for a in (
            head, tail, q0, T0, pts, mask)), max_iters=20, method="lmbm")
    traj, rt = backend.optimize(
        make_shape("Ball", tc), tc, head, tail, q0, T0, pts, mask,
        max_iters=20, method="lmbm", device="cpu", dtype=F64)
    record_property("iters_evals", (rt.n_iters, rt.n_evals))
    record_property("x_gap", float(np.abs(rt.x.numpy() - np.asarray(rj.x))
                                   .max()))
    record_property("f_rel_gap", abs(float(rt.f) / float(rj.f) - 1.0))
    assert (rt.n_iters, rt.n_evals) == (int(rj.n_iters), int(rj.n_evals))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)
    np.testing.assert_allclose(float(rt.f), float(rj.f), rtol=1e-7)
    assert rt.aux.shape == (len(pts),)
    assert bool(torch.isfinite(traj.coeffs).all())
