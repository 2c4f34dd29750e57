"""Scenario-parallel batch engine: many independent (map × shape × goal)
trajectory solves advanced together on one card or over a mesh of ranks
(counterpart of ``isdf_tpu/parallel/batch.py``).

The JAX package vmaps one scenario's solve; here every function of the cost
carries the scenario axis B itself (core/minco, core/poly, sweep/fast_eval,
sweep/sweep_sdf, opt/backend), the swept SDF of all B × P queries is one
launch of K2 (sweep/fused_zoom.sweep_warm_fused_batched), and
``opt/lbfgs.minimize_lockstep`` advances every scenario's L-BFGS by one trial
per loop trip.  Scenarios that converge early are frozen (masked no-ops)
while the others run.  The host reads device values once per chunk, through
``obs.host_read``; a chunked solve is an ``obs`` span, ``batch.solve``, and
each loop trip one ``lockstep.trip``.

Over several ranks (parallel/mesh.py): ``shard_batch`` gives each rank its
block of scenarios (dp) and of each scenario's points (sp) and records the
mesh on the batch.  The entry points read ``batch.mesh``: the cost sums the
points over "sp" (opt/backend.swept_penalty), every host decision reads a
global value, and the results come back whole, in scenario order, on every
rank, as ``np.asarray`` of JAX's sharded outputs does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core import timemap
from isdf_torch.core.poly import PolyTraj
from isdf_torch.device import check_on, resolve_device
from isdf_torch.opt import backend, lbfgs
from isdf_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_dp, global_all, global_min, global_sum, make_mesh,
    shard_batch)
from isdf_torch.sweep.sweep_sdf import sweep_sdf
from isdf_torch.utils import obs


@dataclass(frozen=True)
class ScenarioBatch:
    """Stacked independent planning scenarios (B leading axis)."""

    head: torch.Tensor        # (B, 3, 3)
    tail: torch.Tensor        # (B, 3, 3)
    q0: torch.Tensor          # (B, N-1, 3)
    T0: torch.Tensor          # (B, N)
    points: torch.Tensor      # (B, P, 3) obstacle points (padded)
    mask: torch.Tensor        # (B, P) bool
    # set by shard_batch: the fields are then this rank's block, (B/dp, …)
    # and points/mask (B/dp, P/sp, …)
    mesh: Optional[Mesh] = None

    @classmethod
    def from_arrays(cls, head, tail, q0, T0, points, mask, device=None,
                    dtype=torch.float32) -> "ScenarioBatch":
        """A batch from arrays (the fields of the JAX package's
        ``ScenarioBatch`` as numpy arrays, or anything ``torch.as_tensor``
        takes), placed on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)

        def f(a, dt=dtype):     # a copy: the batch never aliases its source
            return torch.as_tensor(np.array(a), dtype=dt, device=dev)

        batch = cls(head=f(head), tail=f(tail), q0=f(q0), T0=f(T0),
                    points=f(points), mask=f(mask, torch.bool))
        B, N = batch.T0.shape
        P = batch.points.shape[1]
        want = dict(head=(B, 3, 3), tail=(B, 3, 3), q0=(B, N - 1, 3),
                    points=(B, P, 3), mask=(B, P))
        for name, shp in want.items():
            if tuple(getattr(batch, name).shape) != shp:
                raise ValueError(f"{name} {tuple(getattr(batch, name).shape)}"
                                 f", expected {shp}")
        return batch

    @property
    def device(self) -> torch.device:
        return self.points.device

    def map(self, fn: Callable) -> "ScenarioBatch":
        """The batch of ``fn`` applied to each array field (for instance
        ``lambda t: t[rows]``), with no mesh."""
        return ScenarioBatch(fn(self.head), fn(self.tail), fn(self.q0),
                             fn(self.T0), fn(self.points), fn(self.mask))


def _device_of(batch: ScenarioBatch, device) -> torch.device:
    """The device an entry point was asked for (None: the card); the batch
    must already lie there."""
    dev = resolve_device(device)
    check_on(dev, head=batch.head, tail=batch.tail, q0=batch.q0, T0=batch.T0,
             points=batch.points, mask=batch.mask)
    return dev


def _cost_fn(shape, conf, batch: ScenarioBatch):
    N = batch.T0.shape[1]
    mesh = batch.mesh
    return backend.make_cost_fn(
        shape, fl.FlatParams.from_config(conf),
        backend.BackendWeights.from_config(conf), batch.head, batch.tail, N,
        batch.points, batch.mask,
        integral_res=conf.integralIntervs,
        coarse_n=conf.sweep_coarse_samples,
        refine_rounds=conf.sweep_refine_rounds,
        # sp = 1 places no collective: a (dp, 1) mesh runs today's path
        sp_group=mesh.sp_group if mesh is not None and mesh.sp > 1 else None,
    )


def _gathered(batch: ScenarioBatch, *xs):
    return tuple(gather_dp(x, batch.mesh) for x in xs)


def _x0(batch: ScenarioBatch) -> torch.Tensor:
    return backend.pack(timemap.T_to_tau(batch.T0), batch.q0)


def _lockstep(conf, cost_and_grad, x0, t_warm, max_iters, **kw):
    return lbfgs.minimize_lockstep(
        cost_and_grad, x0, t_warm, m=conf.mem_size, max_iters=max_iters,
        g_epsilon=1e-7, past=conf.past, rel_cost_tol=conf.relCostTol, **kw)


@torch.no_grad()
def _finish(batch: ScenarioBatch, x):
    traj, T, _ = backend.build_traj(x, batch.T0.shape[1], batch.head,
                                    batch.tail)
    return traj.coeffs, T


def batched_cost_and_grad(shape, conf, batch: ScenarioBatch, device=None):
    """One cost+gradient evaluation across all scenarios, from the cold
    start (t* warm seeds 0) → (f (B,), g (B, 4N−3)); over a mesh, every
    scenario's on every rank."""
    _device_of(batch, device)
    f, g, _ = _cost_fn(shape, conf, batch)(
        _x0(batch), torch.zeros_like(batch.points[..., 0]))
    return _gathered(batch, f, g)


def batched_solve(shape, conf, batch: ScenarioBatch, max_iters: int = 50,
                  device=None):
    """Full batched back-end solve, every scenario's L-BFGS in lockstep →
    (coeffs (B, N, 6, 3), T (B, N), final costs (B,), iters (B,)); over a
    mesh, every scenario's on every rank.  The lockstep loop runs a fixed
    number of trips and reads nothing on the host, so the ranks stay
    together without a global decision."""
    _device_of(batch, device)
    res = _lockstep(conf, _cost_fn(shape, conf, batch), _x0(batch),
                    torch.zeros_like(batch.points[..., 0]), max_iters)
    coeffs, T = _finish(batch, res.x)
    return _gathered(batch, coeffs, T, res.f, res.n_iters)


def batched_solve_chunked(shape, conf, batch: ScenarioBatch,
                          max_iters: int = 50, chunk: int = 8,
                          callback: Optional[Callable] = None, t_warm0=None,
                          device=None):
    """Chunked batched solve: up to ``chunk`` accepted L-BFGS steps per
    scenario per chunk (2·chunk + 8 loop trips of two cost evaluations
    each), the full solver state carried across chunks.  Between chunks the
    host calls ``callback(result)`` and reads ``converged`` once — the only
    device values it reads; over a mesh the loop ends when every scenario
    of every rank has converged, and ``callback`` sees this rank's block.
    t_warm0 (B, P), placed like ``batch.mask``, optionally seeds the
    per-point argmin-time warm starts (the audited re-solve path).
    Returns (coeffs, T, costs, iters), over a mesh every scenario's on every
    rank."""
    _device_of(batch, device)
    return _gathered(batch, *_solve_chunked(shape, conf, batch, max_iters,
                                            chunk, callback, t_warm0))


def _solve_chunked(shape, conf, batch: ScenarioBatch, max_iters: int,
                   chunk: int, callback: Optional[Callable] = None,
                   t_warm0=None):
    """batched_solve_chunked on this rank's block → its (coeffs, T, costs,
    iters).  The ``batch.solve`` span counts its chunks, loop trips and
    host reads."""
    with obs.span("batch.solve") as sp:
        if t_warm0 is None:
            t_warm0 = torch.zeros_like(batch.points[..., 0])
        cost_and_grad = _cost_fn(shape, conf, batch)
        kw = dict(trace_len=2 * chunk + 8)
        res = _lockstep(conf, cost_and_grad, _x0(batch), t_warm0, chunk,
                        **kw)
        chunks, trips, reads = 1, res.n_loops, 0
        iters_done = chunk
        while iters_done < max_iters:
            if callback is not None:
                callback(res)
            reads += 1
            if global_all(res.converged, batch.mesh):
                break
            res = _lockstep(conf, cost_and_grad, res.x, res.aux, chunk,
                            resume_state=res.state, **kw)
            chunks, trips = chunks + 1, trips + res.n_loops
            iters_done += chunk
        coeffs, T = _finish(batch, res.x)
        sp.set(chunks=chunks, trips=trips, host_reads=reads)
    return coeffs, T, res.f, res.n_iters


@torch.no_grad()
def _batched_audit(shape, conf, batch: ScenarioBatch, coeffs, T,
                   coarse_n: int):
    """High-time-resolution batched swept-SDF audit of solved trajectories:
    every scenario's sweep over all its obstacle points at ``coarse_n`` time
    samples (≫ the solve's sweep_coarse_samples, so thin-wall crossing dips
    the optimizer's scan aliased over are caught), cold — K2 with
    t_warm = 0 and window 0.3.  Returns (sdf, t*) (B, P)."""
    sdf, t_star, _ = sweep_sdf(
        shape, PolyTraj(T, coeffs), fl.FlatParams.from_config(conf),
        batch.points, coarse_n=coarse_n,
        refine_rounds=conf.sweep_refine_rounds, device=batch.device)
    return sdf, t_star


@torch.no_grad()
def _batched_junctions(coeffs, T):
    """Interior junction positions (B, N−1, 3)."""
    return PolyTraj(T, coeffs).junction_positions()[:, 1:-1]


def batched_solve_audited(shape, conf, batch: ScenarioBatch,
                          max_iters: int = 50, chunk: int = 8,
                          audit_coarse_n: int = 512, margin: float = 1e-3,
                          reserve_points=None, reserve_mask=None,
                          inject_budget: int = 64, device=None):
    """Batched solve + the safety audit/inject/re-solve loop — the batched
    twin of PlannerManager.plan's audit step.  Per round: (a) a
    high-resolution argmin-time scan over every scenario's full point set
    (catches dips the solve's coarser scan aliased over), (b) optionally,
    the same scan over a per-scenario reserve point pool — voxels the solve
    never saw — with the ``inject_budget`` nearest-grazing reserve points
    swapped into fixed extra point slots, and (c) a warm re-solve in which
    every grazing point's t* is seeded from the audit scan.  Scenarios with
    no violations re-solve from their own converged state in lockstep.

    reserve_points: (B, R, 3) optional; reserve_mask: (B, R).  Over a mesh
    they are the global pool, as every rank builds it: each rank keeps its
    scenarios' rows (the pool splits over "dp" and is whole on every "sp"
    rank), and the injected slots split over "sp" as the points do.  Every
    decision of the loop reads global counts.
    Returns (coeffs, T, costs, iters, audit): audit = dict with the
    violation count per round (solve set + reserve) and the final min SDF
    per scenario over both sets; over a mesh, every scenario's on every
    rank.
    """
    dev = _device_of(batch, device)
    mesh = batch.mesh
    kw = dict(max_iters=max_iters, chunk=chunk)
    coeffs, T, costs, iters = _solve_chunked(shape, conf, batch, **kw)
    B, P = batch.mask.shape
    history = []
    sdf = None
    min_sdf_reserve = None
    near_thresh = max(float(conf.safety_hor) * 0.5, margin)
    solve_batch = batch      # grows by inject_budget slots on first inject
    rounds = max(int(conf.safety_replan_rounds), 1)
    inf = torch.tensor(float("inf"), dtype=batch.points.dtype, device=dev)
    if reserve_points is not None:
        reserve_points = torch.as_tensor(
            reserve_points, dtype=batch.points.dtype, device=dev)
        reserve_mask = torch.ones(
            reserve_points.shape[:2], dtype=torch.bool, device=dev) \
            if reserve_mask is None else torch.as_tensor(
                reserve_mask, dtype=torch.bool, device=dev)
        K = min(int(inject_budget), reserve_points.shape[1])
        k_rows = slice(0, K)
        if mesh is not None:    # this rank's scenarios, its K/sp slots
            rows = mesh.block(reserve_points.shape[0], "dp")
            reserve_points, reserve_mask = (reserve_points[rows],
                                            reserve_mask[rows])
            k_rows = mesh.block(K, "sp")
    for rnd in range(rounds + 1):   # the last pass audits the last re-solve
        sdf, t_star = _batched_audit(shape, conf, solve_batch, coeffs, T,
                                     audit_coarse_n)
        viol = obs.host_read(global_sum(
            ((sdf <= margin) & solve_batch.mask).sum(), mesh), int)
        inj = None
        if reserve_points is not None:
            sdf_r, t_star_r = _batched_audit(
                shape, conf, replace(batch, points=reserve_points), coeffs,
                T, audit_coarse_n)
            sdf_r = torch.where(reserve_mask, sdf_r, inf)
            # the pool is whole on every "sp" rank: count it over "dp"
            viol += obs.host_read(global_sum((sdf_r <= margin).sum(), mesh,
                                             "dp"), int)
            min_sdf_reserve = sdf_r.min(dim=1).values
            # promote the K nearest-grazing reserve points into the extra
            # slots (a fixed K keeps the re-solve's shapes stable)
            order = torch.argsort(sdf_r, dim=1, stable=True)[:, :K][:, k_rows]
            inj_pts = torch.gather(reserve_points, 1,
                                   order[:, :, None].expand(-1, -1, 3))
            inj_sdf = torch.gather(sdf_r, 1, order)
            inj_t = torch.gather(t_star_r, 1, order)
            inj_mask = inj_sdf <= near_thresh
            inj = (inj_pts, inj_mask,
                   torch.where(inj_mask, inj_t, torch.zeros_like(inj_t)))
        history.append(viol)
        if viol == 0 or rnd == rounds:
            break
        near = (sdf <= near_thresh) & solve_batch.mask
        t_warm = torch.where(near, t_star, torch.zeros_like(t_star))
        solve_batch = replace(solve_batch, q0=_batched_junctions(coeffs, T),
                              T0=T)
        if inj is not None:
            inj_pts, inj_mask, inj_t = inj
            solve_batch = replace(
                solve_batch,
                points=torch.cat([solve_batch.points[:, :P], inj_pts], 1),
                mask=torch.cat([solve_batch.mask[:, :P], inj_mask], 1))
            t_warm = torch.cat([t_warm[:, :P], inj_t], dim=1)
        coeffs, T, costs, iters = _solve_chunked(
            shape, conf, solve_batch, t_warm0=t_warm, **kw)
    min_sdf = global_min(torch.where(solve_batch.mask, sdf, inf).min(
        dim=1).values, mesh, "sp")
    if min_sdf_reserve is not None:
        min_sdf = torch.minimum(min_sdf, min_sdf_reserve)
    coeffs, T, costs, iters, min_sdf = _gathered(batch, coeffs, T, costs,
                                                 iters, min_sdf)
    return coeffs, T, costs, iters, {
        "violations_per_round": history,
        "min_sdf": min_sdf.cpu().numpy(),
    }


def make_random_batch(conf, B: int, N: int = 4, n_points: int = 128,
                      seed: int = 0, device=None,
                      dtype=torch.float32) -> ScenarioBatch:
    """Synthetic but nontrivial scenario batch (random goals + obstacle
    clusters along the straight line) for benchmarks and smoke runs.  The
    numpy draws are those of the JAX package's ``make_random_batch``, in
    its order, so both packages get the same batch from a seed."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform(4.0, 8.0, size=(B, 3)) * np.array([1.0, 0.5, 0.3])
    head = np.zeros((B, 3, 3))
    tail = np.zeros((B, 3, 3))
    tail[:, :, 0] = goals
    fracs = np.linspace(0, 1, N + 1)[1:-1]
    q0 = goals[:, None, :] * fracs[None, :, None]
    q0 = q0 + rng.normal(scale=0.2, size=q0.shape)
    T0 = np.full((B, N), conf.inittime)
    t = rng.uniform(0.1, 0.9, size=(B, n_points, 1))
    points = goals[:, None, :] * t + rng.normal(scale=0.8,
                                                size=(B, n_points, 3))
    mask = np.ones((B, n_points), dtype=bool)
    return ScenarioBatch.from_arrays(head, tail, q0, T0, points, mask,
                                     device=device, dtype=dtype)
