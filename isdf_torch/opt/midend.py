"""Mid-end warm-start trajectory generator (counterpart of
``isdf_tpu/opt/midend.py``; ref mid_end.hpp:341, mid_end.cpp:3-133).

Fits a MINCO trajectory through the A* waypoints minimizing
  energy + ρ_mid Σ T + w_pr Σ_i ‖pos_i − ref_i‖³  [+ attitude tracking]
where pos_i samples the start of piece i+1 (local time T_{i+1}/integralRes)
and ref_i are the subsampled A* waypoints.  The solution x = [τ | ξ]
warm-starts the back end.

The cost is :class:`MidCost`, a function of tensors only (x, the boundary
states, the waypoint attractors, the attitude references) with its scalars
bound.  On the card an evaluation, forward and backward, replays one CUDA
graph (:class:`_Graph`), kept in ``GRAPHS`` per :meth:`MidCost.key`
(lifecycle: ``opt/graphs.py``).  Each evaluation is an ``obs`` span,
``mid_end.eval``, whose ``graph`` attribute says how it ran.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import beta
from isdf_torch.opt import lbfgs
from isdf_torch.opt.attitude import attitude_penalty, pad_attitude_refs
from isdf_torch.opt.backend import build_traj, pack
from isdf_torch.opt.graphs import GraphCache, capture, copy_in
from isdf_torch.utils import obs


@dataclass(frozen=True)
class MidCost:
    """The mid end's cost with its scalars bound; ``att`` None (or
    ``weight_ar`` 0) leaves the attitude term out."""
    N: int
    rho_mid: float
    weight_pr: float
    integral_res: int
    weight_ar: float
    smooth_fac: float
    params: Any
    bridge: bool

    def cost(self, x, head, tail, ref_points, att):
        traj, T, _ = build_traj(x, self.N, head, tail)
        e = minco.energy(traj.coeffs, T)
        t_cost = self.rho_mid * torch.sum(T)
        s = (1.0 / self.integral_res) * T[1:]
        pos = torch.einsum("nk,nkd->nd", beta(s, 0), traj.coeffs[1:])
        diff = pos - ref_points
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        total = e + t_cost + self.weight_pr * torch.sum(dist ** 3)
        if att is not None and self.weight_ar > 0.0:
            total = total + attitude_penalty(
                traj, self.params, att, self.weight_ar, self.smooth_fac,
                self.integral_res, bridge=self.bridge)
        return total

    def value_and_grad(self, x, head, tail, ref_points, att):
        """→ (f, g), detached."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = self.cost(xg, head, tail, ref_points, att)
            (g,) = torch.autograd.grad(f, xg)
        return f.detach(), g

    def key(self, x, ref_points, att) -> tuple:
        """What the evaluation's work depends on besides the tensors'
        values: a graph captured under one key replays for every other."""
        return (self, type(self.params), x.dtype, x.device,
                tuple(ref_points.shape),
                None if att is None else tuple(att.shape))


class _Graph:
    """The evaluation of one key, captured on the first call.  A call copies
    its inputs into the graph's, replays it and clones its output (f | g),
    so that no evaluation's answer aliases the next one's."""

    def __init__(self, cost: MidCost):
        self.cost = cost
        self.static = self.graph = None

    def __call__(self, *args):
        self.static = copy_in(self.static, args)
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            self.flat = capture(graph, lambda: _flat(
                *self.cost.value_and_grad(*self.static)))
            self.graph = graph
        self.graph.replay()
        out = self.flat.clone()
        return out[0], out[1:]


def _flat(f, g):
    """f and g in one flat tensor."""
    return torch.cat([f.reshape(1), g])


GRAPHS = GraphCache(_Graph)    # the mid end's graphs, by MidCost.key


def make_cost_fn(head, tail, N: int, ref_points, rho_mid: float,
                 weight_pr: float, integral_res: int = 64, att=None,
                 weight_ar: float = 0.0, smooth_fac: float = 1e-2,
                 params=None, bridge: bool = True):
    """ref_points: (N−1, 3) waypoint attractors; att: optional (N+1, 3, 3)
    junction attitude references (enables the attitude term).  On CUDA
    tensors the evaluation replays a graph (module docstring)."""
    if weight_ar <= 0.0:
        att = None
    cost = MidCost(N, rho_mid, weight_pr, integral_res, weight_ar,
                   smooth_fac, params, bridge)
    args = (head, tail, ref_points, att)

    def raw_cost(x):
        return cost.cost(x, *args)

    def cost_and_grad(x, aux):
        entry = GRAPHS.entry(cost.key(x, ref_points, att), cost) \
            if x.is_cuda else None
        with obs.span("mid_end.eval") as s:
            mode, (f, g) = GRAPHS.run(entry, (x,) + args,
                                      lambda: cost.value_and_grad(x, *args))
            s.set(graph=mode)
        return f, g, aux

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
