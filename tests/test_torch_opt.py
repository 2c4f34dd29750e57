"""isdf_torch optimizers against isdf_tpu, float64 on the CPU: one back-end
cost and gradient at the same (x, t_warm) (rtol 1e-6), L-BFGS iterates on
Rosenbrock for 20 iterations, and the mid-end solve (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.opt import backend as jbackend
from isdf_tpu.opt import lbfgs as jlbfgs
from isdf_tpu.opt import midend as jmidend
from isdf_tpu.opt.attitude import pad_attitude_refs as jpad
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.sweep.sweep_sdf import sweep_sdf_warm as jsweep_sdf_warm

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.opt import backend, lbfgs, midend
from isdf_torch.opt.attitude import pad_attitude_refs
from isdf_torch.shapes import make_shape
from isdf_torch.sweep.sweep_sdf import sweep_sdf_warm

F64 = torch.float64
CONF = dict(vmax=3.0, omgmax=2.0, thetamax=0.6, safety_hor=0.4,
            integralIntervs=16, weight_ar_backend=500.0,
            poly_params=(0.0, 0.0, 0.0, 120.0, 0.0, 0.0))


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _rot_refs(n, seed):
    rng = np.random.default_rng(seed)
    r, p = rng.uniform(-0.6, 0.6, size=(2, n))
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    R = np.zeros((n, 3, 3))
    R[:, 0, 0], R[:, 0, 2] = cp, sp
    R[:, 1, 0], R[:, 1, 1], R[:, 1, 2] = sr * sp, cr, -sr * cp
    R[:, 2, 0], R[:, 2, 1], R[:, 2, 2] = -cr * sp, sr, cr * cp
    return R


def test_backend_cost_and_grad_matches_jax():
    N = 5
    rng = np.random.default_rng(0)
    q = (np.linspace(2, 8, N - 1)[:, None] * np.array([1.0, 0.4, 0.1])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    x = np.concatenate([rng.normal(scale=0.2, size=N), q.ravel()])
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    tail[:, 0] = [10.0, 4.0, 1.0]
    pts = rng.uniform(0.0, 9.0, size=(128, 3)) * [1.0, 0.5, 0.3]
    mask = np.ones(len(pts), bool)
    mask[-16:] = False
    rot = _rot_refs(N - 1, 1)
    jc, tc = JConfig(**CONF), Config(**CONF)
    js, ts_ = jmake_shape("RoundedCone", jc), make_shape("RoundedCone", tc)
    jp, tp = jfl.FlatParams.from_config(jc), fl.FlatParams.from_config(tc)
    kw = dict(integral_res=16, coarse_n=32, refine_rounds=8,
              weight_ar=500.0)
    j = lambda a: jnp.asarray(np.array(a))

    # t_warm: a sweep's t*; obstacles whose t* the two packages place on
    # different sides of a jump of the frozen-t* gradient (two minima of
    # equal depth, a piece junction) are masked off
    jtraj, _, _ = jbackend.build_traj(j(x), N, j(head), j(tail))
    tw = rng.uniform(0.0, float(jtraj.total_duration), size=len(pts))
    t_j = np.asarray(jsweep_sdf_warm(js, jtraj, jp, j(pts), j(tw),
                                     coarse_n=32, refine_rounds=8)[1])
    ttraj, _, _ = backend.build_traj(_t(x), N, _t(head), _t(tail))
    t_t = sweep_sdf_warm(ts_, ttraj, tp, _t(pts), _t(tw), coarse_n=32,
                         refine_rounds=8, device="cpu")[1].numpy()
    junctions = np.cumsum(ttraj.durations.numpy())[:-1]
    off = np.abs(t_t[:, None] - junctions[None, :]).min(axis=1) > 1e-3
    agree = np.abs(t_j - t_t) < 1e-4
    assert agree.mean() > 0.9 and off.mean() > 0.8
    mask &= agree & off

    jcg = jbackend.make_cost_fn(
        js, jp, jbackend.BackendWeights.from_config(jc), j(head), j(tail), N,
        j(pts), j(mask), att=jpad(j(rot)), **kw)
    fj, gj, tj = jax.jit(jcg)(j(x), j(tw))
    tcg = backend.make_cost_fn(
        ts_, tp, backend.BackendWeights.from_config(tc), _t(head), _t(tail),
        N, _t(pts), torch.as_tensor(mask), att=pad_attitude_refs(_t(rot)),
        **kw)
    ft, gt, tt = tcg(_t(x), _t(tw))
    np.testing.assert_allclose(tt.numpy(), t_t, rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-6)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-6,
                               atol=1e-6 * np.abs(gj).max())


def _rosen(xp):
    def f(x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    return f


def test_lbfgs_iterates_match_jax_on_rosenbrock():
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.5, -1.0])
    fj = _rosen(jnp)

    def jcg(x, aux):
        f, g = jax.value_and_grad(fj)(x)
        return f, g, aux

    ft = _rosen(torch)

    def tcg(x, aux):
        xg = x.detach().requires_grad_(True)
        f = ft(xg)
        (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g, aux

    kw = dict(m=8, max_iters=20, g_epsilon=1e-12, rel_cost_tol=0.0)
    rj = jlbfgs.minimize(jcg, jnp.asarray(x0), None, **kw)
    rt = lbfgs.minimize(tcg, _t(x0), None, **kw)
    assert rt.n_iters == int(rj.n_iters) == 20
    assert rt.n_evals == int(rj.n_evals)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-10)


def test_midend_matches_jax():
    N = 5
    rng = np.random.default_rng(4)
    wps = (np.linspace(2, 10, N - 1)[:, None] * np.array([1.0, 0.5, 0.1])
           + rng.normal(scale=0.3, size=(N - 1, 3)))
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    head[:, 0] = [0.0, 0.0, 1.0]
    tail[:, 0] = [12.0, 6.0, 1.5]
    T0 = np.full(N, 2.0)
    rot = _rot_refs(N - 1, 5)
    conf = dict(integralIntervs=16, weight_ar=2000.0)
    j = lambda a: jnp.asarray(np.array(a))
    _, xj, rj = jmidend.get_ori_traj(JConfig(**conf), j(head), j(tail),
                                     j(wps), j(T0), rot_refs=j(rot),
                                     max_iters=60)
    _, xt, rt = midend.get_ori_traj(Config(**conf), _t(head), _t(tail),
                                    _t(wps), _t(T0), rot_refs=_t(rot),
                                    max_iters=60)
    assert rt.n_iters > 5
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-6)
