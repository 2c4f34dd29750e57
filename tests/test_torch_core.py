"""isdf_torch core math against isdf_tpu, float64 on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart: MINCO solve and energy (rtol 1e-8, the repo's
MINCO parity band), the energy gradient through the solve (autograd vs
jax.grad, rtol 1e-7), the flatness maps (1e-7), and the small helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import minco as jminco
from isdf_tpu.core import smoothing as jsm
from isdf_tpu.core import so3 as jso3
from isdf_tpu.core import timemap as jtm
from isdf_tpu.core.poly import PolyTraj as JPolyTraj

from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, smoothing, so3, timemap
from isdf_torch.core.poly import PolyTraj

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _problem(seed, N, s=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N - 1, 3)) * 2.0
    T = rng.uniform(0.6, 2.0, size=N)
    head = rng.normal(size=(3, s)) * 0.5
    tail = rng.normal(size=(3, s)) * 0.5
    return q, T, head, tail


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("N", [1, 5])
def test_minco_solve_and_energy(s, N):
    q, T, head, tail = _problem(10 * s + N, N, s)
    cj = np.asarray(jminco.solve(jnp.asarray(q), jnp.asarray(T),
                                 jnp.asarray(head), jnp.asarray(tail), s=s))
    ct = minco.solve(_t(q), _t(T), _t(head), _t(tail), s=s)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-8, atol=1e-10)
    ej = float(jminco.energy(jnp.asarray(cj), jnp.asarray(T), s=s))
    et = float(minco.energy(ct, _t(T), s=s))
    np.testing.assert_allclose(et, ej, rtol=1e-8)


def test_energy_gradient_through_solve():
    q, T, head, tail = _problem(3, 6)

    def jf(q, T):
        return jminco.energy(
            jminco.solve(q, T, jnp.asarray(head), jnp.asarray(tail)), T)

    gq_j, gT_j = jax.grad(jf, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(T))
    qt = _t(q).requires_grad_(True)
    Tt = _t(T).requires_grad_(True)
    e = minco.energy(minco.solve(qt, Tt, _t(head), _t(tail)), Tt)
    gq_t, gT_t = torch.autograd.grad(e, (qt, Tt))
    np.testing.assert_allclose(gq_t.numpy(), np.asarray(gq_j), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(gT_t.numpy(), np.asarray(gT_j), rtol=1e-7,
                               atol=1e-9)


def test_polytraj_evaluation():
    rng = np.random.default_rng(5)
    T = rng.uniform(0.5, 1.5, size=4)
    C = rng.normal(size=(4, 6, 3))
    ts = np.linspace(-0.1, T.sum() + 0.1, 57)
    jt, tt = JPolyTraj(jnp.asarray(T), jnp.asarray(C)), PolyTraj(_t(T), _t(C))
    for a, b in zip(jax.vmap(jt.pvaj)(jnp.asarray(ts)), tt.pvaj(_t(ts))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_allclose(tt.junction_positions().numpy(),
                               np.asarray(jt.junction_positions()),
                               rtol=1e-10, atol=1e-10)


def _states(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 3.0,
            rng.normal(size=(n, 3)) * 4.0, rng.normal(size=(n, 3)) * 5.0)


def test_flatness_pose_and_rates():
    pos, vel, acc, jer = _states(7)
    jp, tp = jfl.FlatParams(), fl.FlatParams()
    xj, Rj = jfl.pose_of(*map(jnp.asarray, (pos, vel, acc, jer)), jp)
    xt, Rt = fl.pose_of(*map(_t, (pos, vel, acc, jer)), tp)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-7)
    qj, wj = jfl.rates_of(*map(jnp.asarray, (pos, vel, acc, jer)), jp)
    qt, wt = fl.rates_of(*map(_t, (pos, vel, acc, jer)), tp)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-7,
                               atol=1e-7)


def test_flatness_rates_gradient():
    pos, vel, acc, jer = _states(8, n=16)

    def jf(v, a, j):
        q, w = jfl.rates_of(jnp.asarray(pos), v, a, j, jfl.FlatParams())
        return jnp.sum(w * w) + jnp.sum(q[..., 1:] ** 2)

    gj = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (vel, acc, jer)))
    xs = [_t(a).requires_grad_(True) for a in (vel, acc, jer)]
    q, w = fl.rates_of(_t(pos), *xs, fl.FlatParams())
    gt = torch.autograd.grad(torch.sum(w * w) + torch.sum(q[..., 1:] ** 2), xs)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7,
                                   atol=1e-9)


def test_helpers():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.normal(size=50) * 0.02, [0.0, 0.01, -0.01]])
    np.testing.assert_allclose(
        smoothing.smoothed_l1(_t(x), 0.01).numpy(),
        np.asarray(jsm.smoothed_l1(jnp.asarray(x), 0.01)), rtol=1e-12)
    tau = rng.normal(size=20) * 2
    np.testing.assert_allclose(timemap.tau_to_T(_t(tau)).numpy(),
                               np.asarray(jtm.tau_to_T(jnp.asarray(tau))),
                               rtol=1e-12)
    T = rng.uniform(0.1, 5.0, size=20)
    np.testing.assert_allclose(timemap.T_to_tau(_t(T)).numpy(),
                               np.asarray(jtm.T_to_tau(jnp.asarray(T))),
                               rtol=1e-12, atol=1e-14)
    r, p, y = rng.normal(size=(3, 8))
    np.testing.assert_allclose(
        so3.rpy_to_rot(_t(r), _t(p), _t(y)).numpy(),
        np.asarray(jso3.rpy_to_rot(jnp.asarray(r), jnp.asarray(p),
                                   jnp.asarray(y))), rtol=1e-12, atol=1e-14)
    v = rng.normal(size=(8, 3)) * 0.7
    Rj = jso3.exp_rotvec(jnp.asarray(v))
    np.testing.assert_allclose(so3.exp_rotvec(_t(v)).numpy(), np.asarray(Rj),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(so3.log_rot(_t(np.asarray(Rj))).numpy(),
                               np.asarray(jso3.log_rot(Rj)), rtol=1e-9,
                               atol=1e-12)


def test_clip_gradient_matches_jax_at_the_bounds():
    """torch.clamp gives the whole gradient to the input at a bound;
    jnp.clip splits it 0.5/0.5 (min/max ties).  The port's clip keeps JAX's
    convention, which the zoom's clipped candidates and local times hit."""
    x = np.array([0.0, 1.0, 0.5, -1.0, 2.0])
    h = np.ones(5)
    gj = jax.grad(lambda x, h: jnp.sum(jnp.clip(x, 0.0, h)),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(h))
    xt, ht = _t(x).requires_grad_(True), _t(h).requires_grad_(True)
    gt = torch.autograd.grad(smoothing.clip(xt, 0.0, ht).sum(), (xt, ht))
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    xc = _t(x).requires_grad_(True)
    (g_clamp,) = torch.autograd.grad(torch.clamp(xc, 0.0, 1.0).sum(), xc)
    assert g_clamp[0] == 1.0 and float(gj[0][0]) == 0.5
