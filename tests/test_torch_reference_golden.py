"""isdf_torch against the REFERENCE implementation's own goldens, float64
on the CPU: tests/golden/reference_golden.json (the reference's header-only
math, dumped by native/parity/golden_dump.cpp) and
tests/golden/reference_solve_golden.json (the reference's whole back-end
solve, optimize_traj_lmbm with its Fortran LMBM, dumped by
native/parity/ref_solve.cpp), replayed as tests/test_parity_reference.py
replays them for the JAX package, with its tolerances:

  * MINCO S3: coefficients, jerk energy and its gradients, the adjoint
    propagateGrad, trajectory evaluation (1e-8 .. 1e-12);
  * flatness forward_full (thrust, quat, ω) and the hand-written backward
    pass against one autograd VJP (1e-9 / 1e-7);
  * L-BFGS on a strongly convex problem (f* 1e-10, x* 1e-6);
  * the mid-end solve (cost within 1 % / 2 %, positions within 5 cm);
  * the back end's integral penalty and swept penalty at frozen t*, value
    and gradients (1e-8 / 1e-6);
  * the whole solve, both scenarios (gap, slalom): the initial cost and
    gradient (rtol 1e-4, cosine 1 − 1e-4, norm ratio within 1e-3), the
    swept SDF on the reference's own optimum (5e-3), and the full solve
    with both methods, final cost within [0.6, 1.67]× the reference's and
    collision-free.

One difference from the JAX replay: at coarse_n = 128 the port sweeps
through K1's algorithm (its plain version on the CPU), as the JAX package
does on the TPU, where JAX on the CPU runs its non-fused path; the bands
hold for both.  The full solves (80 iterations over 159 and 218 points,
~10–40 s each on the CPU) are marked slow; chip_smoke.py runs all four on
the card.  Left out: ``max_vel_rate_exact``/``max_acc_rate_exact`` (no
counterpart in the port: nothing in either package's plan path calls them)
and tests/test_lmbm_fortran.py's cases, which need the reference's compiled
LMBM library."""

import json
import os

import numpy as np
import pytest
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import PolyTraj
from isdf_torch.core.smoothing import smoothed_l1
from isdf_torch.opt import backend, lbfgs, midend
from isdf_torch.shapes import make_shape
from isdf_torch.sweep import sdf_at_time, sweep_sdf

F64 = torch.float64
HERE = os.path.join(os.path.dirname(__file__), "golden")
# the reference's "no range found" sentinel (sw_manager.hpp:716)
REF_SDF_SENTINEL = 10.0


def _t(a, shape=None):
    a = np.asarray(a, dtype=np.float64)
    return torch.as_tensor(a if shape is None else a.reshape(shape),
                           dtype=F64)


def det(i):
    """The dump's deterministic input stream (golden_dump.cpp det())."""
    return np.sin(0.7 * i + 0.3) * (1.0 + 0.1 * (i % 7))


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(HERE, "reference_golden.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def minco_case(golden):
    g = golden["minco_s3"]
    N = int(g["N"])
    return (g, N, _t(g["head"], (3, 3)), _t(g["tail"], (3, 3)),
            _t(np.reshape(g["q"], (3, N - 1)).T), _t(g["T"]))


def test_minco_coefficients(minco_case):
    g, N, head, tail, q, T = minco_case
    np.testing.assert_allclose(minco.solve(q, T, head, tail).numpy(),
                               np.reshape(g["coeffs"], (N, 6, 3)),
                               rtol=1e-8, atol=1e-10)


def test_minco_energy_and_partials(minco_case):
    g, N, head, tail, q, T = minco_case
    c = _t(g["coeffs"], (N, 6, 3)).requires_grad_(True)
    Tg = T.clone().requires_grad_(True)
    e = minco.energy(c, Tg)
    np.testing.assert_allclose(float(e.detach()), g["energy"], rtol=1e-9)
    gc, gt = torch.autograd.grad(e, (c, Tg))
    np.testing.assert_allclose(gc.numpy(),
                               np.reshape(g["energy_grad_coeffs"], (N, 6, 3)),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(gt.numpy(), g["energy_grad_times"],
                               rtol=1e-8, atol=1e-8)


def test_minco_adjoint_propagate_grad(minco_case):
    """The reference's banded adjoint (minco.hpp:584-654) equals autograd
    through the port's dense solve of <costGradC, c(q, T)> + <costGradT, T>."""
    g, N, head, tail, q, T = minco_case
    qg, Tg = q.clone().requires_grad_(True), T.clone().requires_grad_(True)
    f = (torch.sum(minco.solve(qg, Tg, head, tail)
                   * _t(g["cost_grad_coeffs"], (N, 6, 3)))
         + torch.sum(Tg * _t(g["cost_grad_times"])))
    gq, gt = torch.autograd.grad(f, (qg, Tg))
    np.testing.assert_allclose(gq.numpy(),
                               np.reshape(g["adj_grad_points"], (3, N - 1)).T,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(gt.numpy(), g["adj_grad_times"], rtol=1e-8,
                               atol=1e-8)


def test_trajectory_eval(minco_case):
    g, N, head, tail, q, T = minco_case
    traj = PolyTraj(T, _t(g["coeffs"], (N, 6, 3)))
    ts = _t(g["eval_ts"])
    K = len(ts)
    for ours, key in zip(traj.pvaj(ts), ("eval_pos", "eval_vel", "eval_acc",
                                         "eval_jer")):
        np.testing.assert_allclose(ours.numpy(), np.reshape(g[key], (K, 3)),
                                   rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(float(traj.total_duration),
                               g["total_duration"], rtol=1e-12)


FLAT = fl.FlatParams(mass=0.61, grav=9.8, dh=0.10, dv=0.10, cp=0.01,
                     veps=1.0e-4)


def test_flatness_forward(golden):
    g = golden["flatness"]
    K = int(g["K"])
    vaj = np.reshape(g["vaj"], (K, 9))
    thr, quat, omg = fl.forward_full(
        _t(vaj[:, :3]), _t(vaj[:, 3:6]), _t(vaj[:, 6:9]),
        torch.zeros(K, dtype=F64), torch.zeros(K, dtype=F64), FLAT)
    np.testing.assert_allclose(thr.numpy(), g["thrust"], rtol=1e-9)
    np.testing.assert_allclose(quat.numpy(), np.reshape(g["quat"], (K, 4)),
                               rtol=1e-9)
    np.testing.assert_allclose(omg.numpy(), np.reshape(g["omg"], (K, 3)),
                               rtol=1e-8, atol=1e-10)


def test_flatness_backward_equals_vjp(golden):
    """The reference's hand-written reverse pass (flatness.hpp:230-406)
    equals one autograd VJP of the port's forward."""
    g = golden["flatness"]
    K = int(g["K"])
    vaj = np.reshape(g["vaj"], (K, 9))
    ref = np.reshape(g["backward_totals"], (K, 12))
    for k in range(K):
        v, a, j = (_t(vaj[k, i:i + 3]).requires_grad_(True)
                   for i in (0, 3, 6))
        gpos = np.array([det(k * 7 + 50 + i) for i in range(3)])
        gvel = np.array([det(k * 7 + 53 + i) for i in range(3)])
        gquat = _t([det(k * 9 + 70 + i) for i in range(4)])
        gomg = _t([det(k * 9 + 74 + i) for i in range(3)])
        quat, omg = fl.forward(v, a, j, FLAT)
        tv, ta, tj = torch.autograd.grad((quat, omg), (v, a, j),
                                         (gquat, gomg))
        # pos passes through untouched; the vel cotangent adds directly
        np.testing.assert_allclose(gpos, ref[k, 0:3], rtol=1e-9)
        np.testing.assert_allclose(tv.numpy() + gvel, ref[k, 3:6], rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(ta.numpy(), ref[k, 6:9], rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_allclose(tj.numpy(), ref[k, 9:12], rtol=1e-7,
                                   atol=1e-9)


def test_lbfgs_convex_endpoint(golden):
    g = golden["lbfgs_convex"]
    s, c = _t(g["scale"]), _t(g["center"])

    def cg(x, aux):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            d = xg[1:] - xg[:-1]
            f = (0.5 * torch.sum(s * xg * xg)
                 + torch.sum(torch.log1p((xg - c) ** 2))
                 + 0.25 * torch.sum(d * d))
            (gr,) = torch.autograd.grad(f, xg)
        return f.detach(), gr, aux

    res = lbfgs.minimize(cg, _t(g["x0"]), None, m=8, max_iters=200,
                         g_epsilon=1e-12, past=3, rel_cost_tol=1e-14)
    assert int(g["ret"]) >= 0
    np.testing.assert_allclose(float(res.f), g["f_star"], rtol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), g["x_star"], rtol=1e-6,
                               atol=1e-8)


def test_backend_integral_penalty(golden):
    g = golden["backend_integral"]
    N = int(g["N"])
    w = backend.BackendWeights(
        rho=0.0, weight_p=0.0, weight_v=g["weight_v"],
        weight_omg=g["weight_omg"], weight_theta=g["weight_theta"],
        vmax=g["vmax"], omgmax=g["omgmax"], thetamax=g["thetamax"],
        smooth_fac=g["smooth_fac"], safety_hor=0.0)
    c = _t(g["coeffs"], (N, 6, 3)).requires_grad_(True)
    T = _t(g["T"]).requires_grad_(True)
    val = backend.integral_penalty(PolyTraj(T, c), fl.FlatParams(), w,
                                   int(g["integralRes"]))
    np.testing.assert_allclose(float(val), g["cost"], rtol=1e-8)
    gc, gt = torch.autograd.grad(val, (c, T))
    np.testing.assert_allclose(gc.numpy(),
                               np.reshape(g["grad_coeffs"], (N, 6, 3)),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(gt.numpy(), g["grad_times"], rtol=1e-6,
                               atol=1e-8)


class _QuadShape:
    """sdf(p_rel) = s0 + g·p_rel + ½ p_relᵀ A p_rel (the dump's model)."""

    def __init__(self, s0, g_lin, A):
        self.s0, self.g_lin, self.A = s0, g_lin, A

    def sdf(self, p):
        return (self.s0 + p @ self.g_lin
                + 0.5 * torch.einsum("...i,ij,...j->...", p, self.A, p))


def test_backend_swept_penalty(golden):
    """The swept penalty at frozen t* through the port's sdf_at_time, against
    the reference's hand-chained adjoints (back_end_optimizer.hpp:557-649,
    grad_cost_p_sw)."""
    g = golden["backend_swept"]
    N = int(g["N"])
    shape = _QuadShape(float(g["s0"]), _t(g["g_lin"]), _t(g["A"], (3, 3)))
    c = _t(g["coeffs"], (N, 6, 3)).requires_grad_(True)
    T = _t(g["T"]).requires_grad_(True)
    sdf = sdf_at_time(shape, PolyTraj(T, c), fl.FlatParams(),
                      _t(g["points"], (-1, 3)), _t(g["tstars"]))
    np.testing.assert_allclose(sdf.detach().numpy(), g["sdf_values"],
                               rtol=1e-9, atol=1e-11)
    val = torch.sum(float(g["weight_p"])
                    * smoothed_l1(float(g["safety_hor"]) - sdf, 0.01))
    np.testing.assert_allclose(float(val), g["cost"], rtol=1e-8)
    gc, gt = torch.autograd.grad(val, (c, T))
    np.testing.assert_allclose(gc.numpy(),
                               np.reshape(g["grad_coeffs"], (N, 6, 3)),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(gt.numpy(), g["grad_times"], rtol=1e-6,
                               atol=1e-8)


def test_mid_end_solution(golden):
    """The reference's OriTraj mid-end solve against the port's: the two
    optimizers differ in line-search internals, so parity is at the
    solution: each optimum near-optimal under the port's cost, positions
    within 5 cm."""
    g = golden["mid_end"]
    N = int(g["N"])
    head, tail = _t(g["head"], (3, 3)), _t(g["tail"], (3, 3))
    refp = _t(np.reshape(g["ref_points"], (3, N - 1)).T)
    cg, raw = midend.make_cost_fn(head, tail, N, refp,
                                  rho_mid=float(g["rho"]),
                                  weight_pr=float(g["weightPR"]),
                                  integral_res=int(g["integralRes"]))
    x0 = backend.pack(timemap.T_to_tau(_t(g["T0"])), refp)
    res = lbfgs.minimize(cg, x0, None, m=16, max_iters=400, g_epsilon=0.0,
                         past=10, rel_cost_tol=1e-8)
    traj, _, _ = backend.build_traj(res.x, N, head, tail)
    x_ref = backend.pack(timemap.T_to_tau(_t(g["T_star"])),
                         _t(np.reshape(g["points_star"], (3, N - 1)).T))
    f_ref_port = float(raw(x_ref))
    assert float(res.f) <= f_ref_port * 1.01 + 1e-9, (float(res.f),
                                                      f_ref_port)
    np.testing.assert_allclose(float(res.f), float(g["f_star"]), rtol=2e-2)
    ts_ref = np.asarray(g["eval_ts"])
    pos_ref = np.reshape(g["eval_pos"], (len(ts_ref), 3))
    with torch.no_grad():
        pos = traj.pos(_t(ts_ref / float(g["total_duration"]))
                       * traj.total_duration).numpy()
    assert np.linalg.norm(pos - pos_ref, axis=-1).max() < 0.05


def solve_conf():
    """native/parity/ref_solve.cpp's fillConfig (config_CappedCone.yaml's
    values driving the reference solve), as tests/test_parity_reference.py
    has it."""
    return Config(
        inputdata="shapes/RoundedCone.obj",
        poly_params=(0.0, 0.0, 0.0, 120.0, 0.0, 0.0),
        vehicleMass=0.61, gravAcc=9.8, horizDrag=0.10, vertDrag=0.10,
        parasDrag=0.01, speedEps=1e-4,
        smoothingEps=1e-2, integralIntervs=64,
        vmax=10.0, omgmax=10.0, thetamax=100.0,
        weight_v=1000.0, weight_omg=1000.0, weight_theta=1000.0,
        weight_p=4000.0, rho=20.0, safety_hor=0.866,
        mem_size=16, past=10, relCostTol=1e-16,
        sweep_coarse_samples=128, sweep_refine_rounds=24,
        dtype="float64",
    )


def solve_scenario(g, dtype=F64, device="cpu"):
    """A scenario of reference_solve_golden.json as tensors: (N, head, tail,
    tau0, q0, points)."""
    N = int(g["n_pieces"])
    on = dict(dtype=dtype, device=device)
    return (N, _t(g["head"], (3, 3)).to(**on), _t(g["tail"], (3, 3)).to(**on),
            _t(g["tau0"]).to(**on), _t(g["q0"], (-1, 3)).to(**on),
            _t(g["points"], (-1, 3)).to(**on))


@pytest.fixture(scope="module")
def solve_golden():
    with open(os.path.join(HERE, "reference_solve_golden.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["gap", "slalom"])
def test_solve_initial_cost_and_gradient(solve_golden, name):
    g = solve_golden[name]
    N, head, tail, tau0, q0, pts = solve_scenario(g)
    conf = solve_conf()
    cg = backend.make_cost_fn(
        make_shape("RoundedCone", conf), fl.FlatParams.from_config(conf),
        backend.BackendWeights.from_config(conf), head, tail, N, pts,
        torch.ones(len(pts), dtype=torch.bool),
        integral_res=conf.integralIntervs,
        coarse_n=conf.sweep_coarse_samples,
        refine_rounds=conf.sweep_refine_rounds)
    f0, g0, _ = cg(backend.pack(tau0, q0), torch.zeros(len(pts), dtype=F64))
    np.testing.assert_allclose(float(f0), g["f0"], rtol=1e-4)
    g_ref, g_my = np.asarray(g["g0"]), g0.numpy()
    cos = float(g_my @ g_ref / (np.linalg.norm(g_my) * np.linalg.norm(g_ref)))
    assert cos > 1.0 - 1e-4, cos
    ratio = np.linalg.norm(g_my) / np.linalg.norm(g_ref)
    assert 0.999 < ratio < 1.001, ratio


@pytest.mark.parametrize("name", ["gap", "slalom"])
def test_sweep_on_reference_optimum(solve_golden, name):
    g = solve_golden[name]
    N, head, tail, _, _, pts = solve_scenario(g)
    conf = solve_conf()
    T_ref = _t(g["final_T"])
    q_ref = _t(np.reshape(g["final_q"], (3, N - 1)).T)
    traj = PolyTraj(T_ref, minco.solve(q_ref, T_ref, head, tail))
    samp = np.reshape(g["traj_samples"], (-1, 3))
    with torch.no_grad():
        pos = traj.pos(_t(np.linspace(0.0, 1.0, len(samp)))
                       * traj.total_duration).numpy()
    assert np.abs(pos - samp).max() < 1e-3
    sdf, _, _ = sweep_sdf(make_shape("RoundedCone", conf), traj,
                          fl.FlatParams.from_config(conf), pts, coarse_n=256,
                          refine_rounds=24, device="cpu")
    sdf = sdf.detach().numpy()
    ref = np.asarray(g["sdf_final"])
    near = ref < REF_SDF_SENTINEL - 1e-6
    np.testing.assert_allclose(sdf[near], ref[near], rtol=5e-3, atol=5e-3)
    assert sdf[~near].min() > float(g["min_clearance"])


@pytest.mark.slow
@pytest.mark.parametrize("method", ["lbfgs", "lmbm"])
@pytest.mark.parametrize("name", ["gap", "slalom"])
def test_full_solve_in_band(solve_golden, name, method, record_property):
    g = solve_golden[name]
    N, head, tail, tau0, q0, pts = solve_scenario(g)
    conf = solve_conf()
    shape = make_shape("RoundedCone", conf)
    params = fl.FlatParams.from_config(conf)
    traj, res = backend.optimize(
        shape, conf, head, tail, q0, timemap.tau_to_T(tau0), pts,
        torch.ones(len(pts), dtype=torch.bool), max_iters=80, params=params,
        method=method, device="cpu", dtype=F64)
    ratio = float(res.f) / g["final_cost"]
    record_property("cost_ratio", ratio)
    assert 0.6 < ratio < 1.67, (float(res.f), g["final_cost"])
    sdf, _, _ = sweep_sdf(shape, traj, params, pts, coarse_n=256,
                          refine_rounds=24, device="cpu")
    record_property("min_swept_sdf", float(sdf.min()))
    assert float(sdf.min()) > 0.0
    assert g["min_clearance"] > 0.0
