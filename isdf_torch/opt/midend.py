"""Mid-end warm-start trajectory generator (counterpart of
``isdf_tpu/opt/midend.py``; ref mid_end.hpp:341, mid_end.cpp:3-133).

Fits a MINCO trajectory through the A* waypoints minimizing
  energy + ρ_mid Σ T + w_pr Σ_i ‖pos_i − ref_i‖³  [+ attitude tracking]
where pos_i samples the start of piece i+1 (local time T_{i+1}/integralRes)
and ref_i are the subsampled A* waypoints.  The solution x = [τ | ξ]
warm-starts the back end.  Each cost evaluation is an ``obs`` span,
``mid_end.eval``.
"""

from __future__ import annotations

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import beta
from isdf_torch.opt import lbfgs
from isdf_torch.opt.attitude import attitude_penalty, pad_attitude_refs
from isdf_torch.opt.backend import build_traj, pack
from isdf_torch.utils import obs


def make_cost_fn(head, tail, N: int, ref_points, rho_mid: float,
                 weight_pr: float, integral_res: int = 64, att=None,
                 weight_ar: float = 0.0, smooth_fac: float = 1e-2,
                 params=None, bridge: bool = True):
    """ref_points: (N−1, 3) waypoint attractors; att: optional (N+1, 3, 3)
    junction attitude references (enables the attitude term)."""

    def raw_cost(x):
        traj, T, q = build_traj(x, N, head, tail)
        e = minco.energy(traj.coeffs, T)
        t_cost = rho_mid * torch.sum(T)
        s = (1.0 / integral_res) * T[1:]
        pos = torch.einsum("nk,nkd->nd", beta(s, 0), traj.coeffs[1:])
        diff = pos - ref_points
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        total = e + t_cost + weight_pr * torch.sum(dist ** 3)
        if att is not None and weight_ar > 0.0:
            total = total + attitude_penalty(
                traj, params, att, weight_ar, smooth_fac, integral_res,
                bridge=bridge)
        return total

    def cost_and_grad(x, aux):
        with obs.span("mid_end.eval"), torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = raw_cost(xg)
            (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g, aux

    return cost_and_grad, raw_cost


def get_ori_traj(conf, head, tail, waypoints, T0, rot_refs=None,
                 max_iters: int = 200, params=None):
    """(ref OriTraj::getOriTraj) → (PolyTraj, opt_x warm start, result).

    Tensors in, on their device and dtype; rot_refs: optional (N−1, 3, 3)
    per-waypoint attitude references from the A* SE(3) search; params: the
    pose map of the attitude term (default: the config's FlatParams)."""
    N = T0.shape[0]
    q0 = waypoints
    x0 = pack(timemap.T_to_tau(T0), q0)
    att = None
    if rot_refs is not None and conf.weight_ar > 0.0:
        att = pad_attitude_refs(rot_refs, x0.dtype, x0.device)
        if params is None:
            params = fl.FlatParams.from_config(conf)
    cost_and_grad, _ = make_cost_fn(
        head, tail, N, q0, conf.rho_mid_end, conf.weight_pr,
        conf.integralIntervs, att=att, weight_ar=conf.weight_ar,
        smooth_fac=conf.smoothingEps, params=params,
        bridge=conf.attitude_bridge,
    )
    res = lbfgs.minimize(
        cost_and_grad, x0, None,
        m=conf.mem_size, max_iters=max_iters,
        g_epsilon=max(conf.g_epsilon, 1e-7), past=conf.past,
        rel_cost_tol=conf.relCostTolMidEnd,
    )
    with torch.no_grad():
        traj, _, _ = build_traj(res.x, N, head, tail)
    return traj, res.x, res
