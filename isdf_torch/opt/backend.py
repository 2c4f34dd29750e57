"""Back-end trajectory optimizer (counterpart of ``isdf_tpu/opt/backend.py``:
``method="lbfgs"`` or ``"lmbm"``, optionally monitored).

Decision variables x = [τ (N) | ξ (3(N−1))]: τ maps to piece times through
the diffeomorphism (core/timemap), ξ are the interior waypoints.  One cost
evaluation:

  cost = MINCO jerk energy + ρ Σ T
       + Σ_{pieces × samples} node·step·( w_v S(‖v‖²−v²max)
           + w_ω S(‖ω‖²−ω²max) + w_θ S(acos(cosθ)−θmax) )
       [+ attitude tracking]
       + Σ_{obstacle points} w_p S₀.₀₁(d_safe − SV(p))

where SV is the swept-volume SDF at the per-point argmin time t*,
warm-started across outer iterations and frozen in the gradient (envelope
theorem).  All gradients come from autograd through this scalar.

On the card an evaluation replays two CUDA graphs around the sweep
kernel's eager launch (:class:`SplitCost`): G1 computes the kernel's inputs
from x, G2 the rest of the cost and its gradient at the kernel's constant
(t*, d*, g*).  ``GRAPHS`` keeps them per :meth:`SplitCost.key` (lifecycle:
``opt/graphs.py``), on the kernel sweep (``sweep_sdf.kernel_ok``) without
an "sp" group.  A batch's key runs under cuSOLVER's and cuBLAS's linear
algebra, one trajectory's under PyTorch's default.

Each evaluation is an ``obs`` span, ``back_end.eval``, whose ``graph``
attribute says how it ran (``replay``, ``capture`` or ``eager``) and whose
``pieces`` attribute whether the trajectory's state at t* ran K5
(``kernel``; ``sweep/pieces.py``) or PyTorch operations (``torch``): the
change of ``pieces.LAUNCHES`` across the evaluation, or for a replay across
its graph's capture.  Its one child, ``eval.sweep``, is the sweep kernel's
launch (eagerly, with the re-evaluation at t*).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import PolyTraj, beta
from isdf_torch.core.smoothing import clip, smoothed_l1
from isdf_torch.device import resolve_device
from isdf_torch.opt import lbfgs, lmbm
from isdf_torch.opt.attitude import attitude_penalty, pad_attitude_refs
from isdf_torch.opt.graphs import GraphCache, capture, copy_in
from isdf_torch.parallel.mesh import copy_to_sp, reduce_from_sp
from isdf_torch.sweep import pieces
from isdf_torch.sweep.sweep_sdf import (kernel_args, kernel_ok, launch,
                                        sweep_sdf_warm, sweep_value)
from isdf_torch.utils import obs

WARM_WINDOW = 0.3        # the warm sweep's window around the last t*
# the sweep as imported: a fault or a test that replaces it on this module
# replaces it in the one-piece evaluation, which the graphs would bypass
_SWEEP = sweep_sdf_warm


@dataclass(frozen=True)
class BackendWeights:
    rho: float
    weight_v: float
    weight_omg: float
    weight_theta: float
    weight_p: float
    vmax: float
    omgmax: float
    thetamax: float
    safety_hor: float
    smooth_fac: float

    @classmethod
    def from_config(cls, conf):
        return cls(
            rho=conf.rho, weight_v=conf.weight_v, weight_omg=conf.weight_omg,
            weight_theta=conf.weight_theta, weight_p=conf.weight_p,
            vmax=conf.vmax, omgmax=conf.omgmax, thetamax=conf.thetamax,
            safety_hor=conf.safety_hor, smooth_fac=conf.smoothingEps,
        )


def pack(tau, xi):
    """[τ (..., N) | ξ (..., N−1, 3)] → x (..., 4N−3)."""
    return torch.cat([tau, xi.flatten(-2)], dim=-1)


def unpack(x, N: int):
    return x[..., :N], x[..., N:].reshape(tuple(x.shape[:-1]) + (N - 1, 3))


def build_traj(x, N, head, tail):
    tau, q = unpack(x, N)
    T = timemap.tau_to_T(tau)
    coeffs = minco.solve(q, T, head, tail)
    return PolyTraj(T, coeffs), T, q


def integral_penalty(traj: PolyTraj, params, w: BackendWeights, res: int):
    """Dynamic-feasibility penalties over pieces × (res+1) samples
    (ref addTimeIntPenaltyParallel), trapezoid node weights; per scenario
    for a batched traj."""
    T = traj.durations
    j = torch.arange(res + 1, device=T.device)
    frac = (j / res).to(T.dtype)
    s = T[..., None] * frac                            # (..., N, res+1)
    c = traj.coeffs

    def eval_d(order):
        return torch.einsum("...nsk,...nkd->...nsd", beta(s, order), c)

    vel, acc, jer = eval_d(1), eval_d(2), eval_d(3)
    quat, omg = fl.rates_of(eval_d(0), vel, acc, jer, params)
    if isinstance(params, fl.PlanarPose):
        # planar: the speed is (vx, vy)'s; the third axis is ψ̇
        viola_vel = torch.sum(vel[..., :2] ** 2, dim=-1) - w.vmax ** 2
    else:
        viola_vel = torch.sum(vel * vel, dim=-1) - w.vmax ** 2
    viola_omg = torch.sum(omg * omg, dim=-1) - w.omgmax ** 2
    cos_theta = 1.0 - 2.0 * (quat[..., 1] ** 2 + quat[..., 2] ** 2)
    # the clip margin must be representable in float32 (1−1e-9 rounds to 1,
    # where arccos' = −∞ poisons the backward pass through 0·∞)
    theta = torch.arccos(clip(cos_theta, -1.0 + 1e-6, 1.0 - 1e-6))
    viola_theta = theta - w.thetamax
    pena = (
        w.weight_v * smoothed_l1(viola_vel, w.smooth_fac)
        + w.weight_omg * smoothed_l1(viola_omg, w.smooth_fac)
        + w.weight_theta * smoothed_l1(viola_theta, w.smooth_fac)
    )
    node = torch.where((j == 0) | (j == res), 0.5, 1.0).to(T.dtype)
    step = T / res
    return minco.sum_last(pena * node * step[..., None], 2)


def swept_penalty(shape, traj: PolyTraj, params, w: BackendWeights, points,
                  mask, t_warm, coarse_n: int, refine_rounds: int,
                  sp_group=None):
    """Swept-volume safety penalty over obstacle points (ref
    addSaftyPenaOnSweptVolumeParallel, μ = 0.01) → (cost, new t*); for a
    batched traj, points (B, P, 3) → (cost (B,), t* (B, P)).

    With an "sp" process group the points are this rank's block of each
    scenario's points: the trajectory enters the group through
    ``copy_to_sp`` and the point sum leaves it through ``reduce_from_sp``,
    so cost and gradient are the whole sum's on every rank of the group."""
    if sp_group is not None:
        traj = PolyTraj(copy_to_sp(traj.durations, sp_group),
                        copy_to_sp(traj.coeffs, sp_group))
    sdf, t_star, _ = sweep_sdf_warm(
        shape, traj, params, points, t_warm,
        coarse_n=coarse_n, refine_rounds=refine_rounds,
        warm_window=WARM_WINDOW, device=points.device,
    )
    return reduce_from_sp(safety_cost(w, sdf, mask), sp_group), t_star


def safety_cost(w: BackendWeights, sdf, mask):
    """The penalty's sum over the live obstacle points of the swept SDF."""
    pena = w.weight_p * smoothed_l1(w.safety_hor - sdf, 0.01)
    return minco.sum_last(torch.where(mask, pena, torch.zeros_like(pena)), 1)


class CostBreakdown(NamedTuple):
    total: torch.Tensor
    energy: torch.Tensor
    time: torch.Tensor
    dyn: torch.Tensor
    safety: torch.Tensor


class CostData(NamedTuple):
    """The tensors of one back-end problem besides x and the warm seeds:
    the boundary states, the obstacle points and their mask, and the
    attitude references (None without the attitude term)."""
    head: torch.Tensor
    tail: torch.Tensor
    points: torch.Tensor
    mask: torch.Tensor
    att: Optional[torch.Tensor]


class SplitCost:
    """The cost-and-gradient evaluation cut at the sweep kernel, so that a
    CUDA graph can hold each side of its eager launch: (a)
    :meth:`kernel_args`, the kernel's inputs from x with no grad; (b)
    :meth:`launch`, the kernel; (c) :meth:`remainder`, the trajectory built
    again from x with grad, the cost at the kernel's constant (t*, d*, g*)
    and its gradient.  Run eagerly one after the other, the three give the
    one-piece evaluation's f, g, t* and breakdown, bitwise on the CPU.  Only
    the sweep kernel's path cuts (``kernel_ok``)."""

    def __init__(self, shape, params, w: BackendWeights, N: int,
                 integral_res: int, coarse_n: int, refine_rounds: int,
                 weight_ar: float = 0.0, bridge: bool = True):
        self.shape, self.params, self.w, self.N = shape, params, w, N
        self.integral_res, self.coarse_n = integral_res, coarse_n
        self.refine_rounds = refine_rounds
        self.weight_ar, self.bridge = weight_ar, bridge

    def key(self, x, d: CostData) -> tuple:
        """What the evaluation's work depends on besides the tensors'
        values: graphs captured under one key replay for every other."""
        return (id(self.shape), type(self.params), self.params, self.w,
                self.N, self.integral_res, self.coarse_n, self.refine_rounds,
                WARM_WINDOW, tuple(d.points.shape), x.dtype, x.device,
                None if d.att is None else (tuple(d.att.shape),
                                            self.weight_ar, self.bridge))

    def traj_terms(self, x, d: CostData):
        """(trajectory, MINCO energy, time cost) of x."""
        traj, T, _ = build_traj(x, self.N, d.head, d.tail)
        return (traj, minco.energy(traj.coeffs, T),
                self.w.rho * minco.sum_last(T, 1))

    def dyn_term(self, traj: PolyTraj, d: CostData):
        """The integral penalties, with the attitude term where it is on."""
        dyn = integral_penalty(traj, self.params, self.w, self.integral_res)
        if d.att is not None:
            dyn = dyn + attitude_penalty(
                traj, self.params, d.att, self.weight_ar, self.w.smooth_fac,
                self.integral_res, bridge=self.bridge)
        return dyn

    def kernel_args(self, x, t_warm, d: CostData):
        with torch.no_grad():
            traj, _, _ = build_traj(x.detach(), self.N, d.head, d.tail)
            return kernel_args(self.shape, traj, self.params, d.points,
                               t_warm, self.coarse_n)

    def launch(self, args, dtype):
        return launch(self.shape, self.params, args, self.coarse_n,
                      self.refine_rounds, WARM_WINDOW, dtype)

    def remainder(self, x, d: CostData, kout):
        """→ (f, g, CostBreakdown), detached."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            traj, e, t_cost = self.traj_terms(xg, d)
            dyn = self.dyn_term(traj, d)
            safety = safety_cost(self.w, sweep_value(
                self.shape, traj, self.params, d.points, kout), d.mask)
            total = e + t_cost + dyn + safety
            (g,) = torch.autograd.grad(total.sum(), xg)
        bd = CostBreakdown(*(v.detach() for v in (total, e, t_cost, dyn,
                                                    safety)))
        return bd.total, g, bd


@contextlib.contextmanager
def _linalg(lib):
    """PyTorch's linear-algebra library ``lib`` inside the block (None: the
    one set)."""
    if lib is None:
        yield
        return
    was = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(lib)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(was)


class _Graphs:
    """G1 and G2 of one key, captured on the first call.  A call copies its
    inputs into G1's, replays G1, launches the kernel on G1's outputs,
    copies the kernel's into G2's inputs, replays G2 and clones its output,
    so that no evaluation's answer aliases the next one's.  ``pieces``:
    whether G2 captured K5's launches."""

    def __init__(self, split: SplitCost):
        self.split = split
        self.static = self.kout = self.g1 = self.g2 = None
        self.pieces = False

    def __call__(self, x, t_warm, d: CostData):
        split = self.split
        self.static = copy_in(self.static, (x, t_warm) + tuple(d))
        sx, st, *sd = self.static
        sd = CostData(*sd)
        if self.g1 is None:
            g1 = torch.cuda.CUDAGraph()
            self.args = capture(g1, lambda: split.kernel_args(sx, st, sd))
            self.g1 = g1
        self.g1.replay()
        with obs.span("eval.sweep"):
            kout = split.launch(self.args, x.dtype)
        self.kout = copy_in(self.kout, kout)
        if self.g2 is None:
            g2 = torch.cuda.CUDAGraph()
            launches = pieces.LAUNCHES
            self.f_shape, self.g_shape, self.flat = capture(
                g2, lambda: _flat(*split.remainder(sx, sd, self.kout)),
                pool=self.g1.pool())
            self.pieces = pieces.LAUNCHES > launches
            self.g2 = g2
        self.g2.replay()
        out = self.flat.clone()
        m = out.numel() - math.prod(self.g_shape)
        bd = CostBreakdown(*out[:m].view((5,) + self.f_shape).unbind(0))
        return bd.total, out[m:].view(self.g_shape), kout[0], bd


def _flat(f, g, bd: CostBreakdown):
    """(f's shape, g's shape, the breakdown and g in one flat tensor)."""
    return tuple(f.shape), tuple(g.shape), torch.cat(
        [torch.stack(tuple(bd)).reshape(-1), g.reshape(-1)])


GRAPHS = GraphCache(_Graphs)    # the back end's graphs, by SplitCost.key


def make_cost_fn(shape, params, w: BackendWeights, head, tail, N: int,
                 points, mask, integral_res: int = 64, coarse_n: int = 64,
                 refine_rounds: int = 16, with_breakdown: bool = False,
                 att=None, weight_ar: float = 0.0, bridge: bool = True,
                 sp_group=None):
    """cost_and_grad(x, aux) for opt.lbfgs / opt.lmbm; aux = t* warm starts
    (P,).  With ``with_breakdown`` → (cost_and_grad, raw_cost,
    cost_and_grad_bd): raw_cost(x, t_warm) → (total, (t*, CostBreakdown)),
    and cost_and_grad_bd threads aux = (t_warm, CostBreakdown), so the
    latest breakdown rides in the solver state and a monitor reads it with
    no extra evaluation.

    With a leading scenario axis on head/tail (B, 3, 3), points (B, P, 3),
    mask (B, P), x (B, 4N−3) and aux (B, P), f is the per-scenario cost (B,)
    and g (B, 4N−3) every scenario's own gradient: the scenarios are
    independent, so one backward pass of the summed cost gives them all.  The
    attitude term takes one trajectory only.  ``sp_group``: the "sp" group
    of a mesh whose ranks each hold a block of the points (swept_penalty);
    None, no collective.  On CUDA tensors the evaluation replays graphs
    (module docstring)."""
    if att is not None and weight_ar > 0.0 and head.dim() != 2:
        raise ValueError("the attitude term takes one scenario, not a batch")
    split = SplitCost(shape, params, w, N, integral_res, coarse_n,
                      refine_rounds, weight_ar, bridge)
    data = CostData(head, tail, points, mask,
                    att if att is not None and weight_ar > 0.0 else None)
    graphable = sp_group is None and kernel_ok(shape, coarse_n)

    def raw_cost(x, t_warm):
        traj, e, t_cost = split.traj_terms(x, data)
        dyn = split.dyn_term(traj, data)
        with obs.span("eval.sweep"):
            safety, t_star = swept_penalty(
                shape, traj, params, w, points, mask, t_warm, coarse_n,
                refine_rounds, sp_group)
        total = e + t_cost + dyn + safety
        return total, (t_star, CostBreakdown(total, e, t_cost, dyn, safety))

    def eager(x, t_warm):
        xg = x.detach().requires_grad_(True)
        f, (t_star, bd) = raw_cost(xg, t_warm)
        (g,) = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g, t_star, CostBreakdown(
            *(v.detach() for v in bd))

    def value_and_grad(x, t_warm):
        entry = GRAPHS.entry(split.key(x, data), split) if (
            graphable and x.is_cuda and sweep_sdf_warm is _SWEEP) else None
        # every evaluation of a batch's key runs under cuSOLVER: PyTorch's
        # default takes a batch of small MINCO systems to MAGMA's LU, which
        # no graph holds, and replays must repeat the warm-ups bit for bit
        lib = "cusolver" if entry is not None and x.dim() == 2 else None
        with obs.span("back_end.eval") as s, torch.enable_grad(), \
                _linalg(lib):
            launches = pieces.LAUNCHES
            mode, out = GRAPHS.run(entry, (x, t_warm, data),
                                   lambda: eager(x, t_warm))
            ran = (entry.graphs.pieces if mode == "replay"
                   else pieces.LAUNCHES > launches)
            s.set(graph=mode, pieces="kernel" if ran else "torch")
        return out

    def cost_and_grad(x, aux):
        f, g, t_star, _ = value_and_grad(x, aux)
        return f, g, t_star

    if not with_breakdown:
        return cost_and_grad

    def cost_and_grad_bd(x, aux):
        f, g, t_star, bd = value_and_grad(x, aux[0])
        return f, g, (t_star, bd)

    return cost_and_grad, raw_cost, cost_and_grad_bd


def optimize(shape, conf, head, tail, q0, T0, points, mask, t_warm0=None,
             max_iters: Optional[int] = None, method: str = "lbfgs",
             params=None, rot_refs=None, monitor=None,
             monitor_chunk: int = 4, device=None, dtype=torch.float32):
    """Full back-end solve (ref optimize_traj_lmbm, back_end_optimizer.cpp:
    99) → (PolyTraj, LBFGSResult).  Inputs may be arrays or tensors; they
    are placed on ``device`` (default: the CUDA card) in ``dtype``.
    ``params`` is the pose map (default: the config's FlatParams; PlanarPose
    for the planar planner).

    method: "lbfgs" (the smoothed costs; the reference's declared
    interchangeable variant, hpp:730) or "lmbm" (the nonsmooth bundle loop,
    opt/lmbm.py; the reference's default outer solver).
    monitor: an optional utils.monitor.OptiMonitor (L-BFGS only, as in the
    JAX package): the solve runs in chunks of ``monitor_chunk`` iterations
    and streams a CostBreakdown after each; the monitor's Controller can
    stop it between chunks.  The streamed breakdown is the one of the last
    accepted line-search trial, under the t* warm seeds from before that
    iteration's refresh: a monitor feed, not an exact final cost (it saves
    an evaluation a chunk)."""
    dev = resolve_device(device)

    def on(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=dev)

    head, tail, q0, T0, points = (on(a) for a in (head, tail, q0, T0, points))
    mask = on(mask, torch.bool)
    N = T0.shape[0]
    if params is None:
        params = fl.FlatParams.from_config(conf)
    w = BackendWeights.from_config(conf)
    x0 = pack(timemap.T_to_tau(T0), q0)
    t_warm0 = torch.zeros(points.shape[0], dtype=dtype, device=dev) \
        if t_warm0 is None else on(t_warm0)
    att = None
    if rot_refs is not None and conf.weight_ar_backend > 0.0:
        att = pad_attitude_refs(rot_refs, dtype, dev)
    cost_and_grad, _, cost_and_grad_bd = make_cost_fn(
        shape, params, w, head, tail, N, points, mask,
        integral_res=conf.integralIntervs,
        coarse_n=conf.sweep_coarse_samples,
        refine_rounds=conf.sweep_refine_rounds,
        att=att, weight_ar=conf.weight_ar_backend,
        bridge=conf.attitude_bridge, with_breakdown=True,
    )
    iters = max_iters if max_iters is not None else conf.max_iterations
    lbfgs_kw = dict(g_epsilon=max(conf.g_epsilon, 1e-7), past=conf.past,
                    rel_cost_tol=conf.relCostTol)
    if method == "lmbm":
        res = lmbm.minimize(cost_and_grad, x0, t_warm0, m=conf.mem_size,
                            max_iters=iters)
    elif monitor is not None:
        monitor.begin_solve()
        zero_bd = CostBreakdown(*(torch.zeros((), dtype=dtype,
                                              device=dev),) * 5)
        res = lbfgs.minimize_chunked(
            cost_and_grad_bd, x0, (t_warm0, zero_bd), m=conf.mem_size,
            max_iters=iters, chunk=monitor_chunk,
            # the latest breakdown rides in aux: no re-evaluation
            callback=lambda r: monitor.on_chunk(r.n_iters, r.aux[1]),
            **lbfgs_kw)
        res = replace(res, aux=res.aux[0])
    else:
        res = lbfgs.minimize(cost_and_grad, x0, t_warm0, m=conf.mem_size,
                             max_iters=iters, **lbfgs_kw)
    with torch.no_grad():
        traj, _, _ = build_traj(res.x, N, head, tail)
    return traj, res
