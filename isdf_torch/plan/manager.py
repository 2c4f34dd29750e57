"""Planner orchestration (counterpart of ``isdf_tpu/plan/manager.py``; ref
plan_manager.cpp:130 init, 180 generatePath, 202 generateTraj).

Pipeline per plan request:
  1. front end: SE(3) A* over the occupancy grid with pose kernels
  2. waypoint subsample every ~traj_parlength meters
  3. obstacle gather: occupied voxels in AABBs around the waypoints
  4. mid end: MINCO + waypoint attraction fit → warm start
  5. back end: L-BFGS with the swept-volume SDF safety penalty (K1),
     optionally monitored
  6. swept-SDF audit (K1); violations are injected and re-solved

A plan is an ``obs`` span, ``plan``, with one child a phase:
``plan.front_end``, ``plan.gather``, ``plan.mid_end``, ``plan.back_end``
(one a solve: 0 the first, then the safety re-plans) and ``plan.audit``
(one a round).  ``PlanResult.metrics`` times the same phases whether or not
spans are recorded.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import timemap
from isdf_torch.device import resolve_device
from isdf_torch.opt import backend, midend
from isdf_torch.search.astar import astar_se3, subsample_waypoints
from isdf_torch.search.pose_kernels import (build_pose_kernels,
                                            pose_feasibility)
from isdf_torch.shapes import Shape, make_shape
from isdf_torch.sweep.sweep_sdf import sweep_sdf
from isdf_torch.utils import obs
from isdf_torch.world import aabb
from isdf_torch.world.gridmap import GridMap


@dataclass
class PlanResult:
    success: bool
    traj: Any = None                       # PolyTraj
    path: Optional[np.ndarray] = None      # A* path
    rolls: Optional[np.ndarray] = None
    pitches: Optional[np.ndarray] = None
    metrics: Dict[str, Any] = field(default_factory=dict)


def _resample_by_arclength(path: np.ndarray, n: int, *extras) -> tuple:
    """n interior waypoints uniformly spaced along the path's arclength;
    per-node angle arrays in ``extras`` are resampled by peak-hold (the
    largest-|angle| node within each waypoint's half-spacing cell)."""
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1] if s[-1] > 0 else 1.0
    targets = np.linspace(0.0, total, n + 2)[1:-1]
    out = np.empty((n, 3))
    for ax in range(3):
        out[:, ax] = np.interp(targets, s, path[:, ax])
    h = 0.5 * (targets[1] - targets[0]) if n > 1 else 0.5 * total
    held = []
    for e in extras:
        e = np.asarray(e)
        v = np.empty(n)
        for i, t in enumerate(targets):
            cell = (s >= t - h) & (s <= t + h)
            if cell.any():
                ec = e[cell]
                v[i] = ec[np.argmax(np.abs(ec))]
            else:
                v[i] = np.interp(t, s, e)
        held.append(v)
    return (out,) + tuple(held)


def _rp_to_rot(rolls: np.ndarray, pitches: np.ndarray) -> np.ndarray:
    """Per-waypoint attitude references R = Rx(roll)·Ry(pitch)."""
    cr, sr = np.cos(rolls), np.sin(rolls)
    cp, sp = np.cos(pitches), np.sin(pitches)
    R = np.zeros((len(rolls), 3, 3))
    R[:, 0, 0] = cp
    R[:, 0, 2] = sp
    R[:, 1, 0] = sr * sp
    R[:, 1, 1] = cr
    R[:, 1, 2] = -sr * cp
    R[:, 2, 0] = -cr * sp
    R[:, 2, 1] = sr
    R[:, 2, 2] = cr * cp
    return R


def _solve_counts(sp, solve: int, res):
    """A back-end solve's counts on its ``plan.back_end`` span."""
    sp.set(solve=solve, iterations=res.n_iters, evaluations=res.n_evals,
           trials=res.n_trials)


class PlannerManager:
    """``device=None`` means the CUDA card (raises without one); ``dtype``
    is the working precision of the optimizer (float32 on the card)."""

    def __init__(self, conf: Config, shape: Optional[Shape] = None,
                 shape_name: Optional[str] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.conf = conf
        if shape is None:
            shape = make_shape(shape_name or "Ball", conf)
        self.shape = shape
        self.params = fl.FlatParams.from_config(conf)
        self.gridmap: Optional[GridMap] = None
        self._host_map: Optional[GridMap] = None
        self.feasibility: Optional[np.ndarray] = None
        self.pose_kernels = None

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    # -- map arrival (ref mapRcvCallBack plan_manager.cpp:397-411) -----------
    def set_map_points(self, points: np.ndarray,
                       use_pose_kernels: bool = True):
        gm = GridMap.from_points(
            points, self.conf.mapBound, self.conf.occupancy_resolution,
            self.conf.sta_threshold, device=self.device)
        self.set_map(gm, use_pose_kernels=use_pose_kernels)

    def set_map(self, gm: GridMap, use_pose_kernels: bool = True):
        """A new map.  With ``use_pose_kernels`` the pose-feasibility
        volume is rebuilt for it (the pose kernels themselves depend on the
        shape alone and are built once); without, the front end is plain
        occupancy A* and no attitude references exist."""
        self.gridmap = gm
        self._host_map = gm.cpu()       # for the host-side obstacle gathers
        if use_pose_kernels:
            if self.pose_kernels is None:
                # shape-only precompute, reused across map updates (a
                # closed loop rebuilds only the feasibility convolution)
                self.pose_kernels = build_pose_kernels(
                    self.shape, self.conf, device=self.device)
            feas = pose_feasibility(gm.occ.to(self.device),
                                    self.pose_kernels.kernels)
            self.feasibility = feas.cpu().numpy()

    def snap_feasible(self, p, max_radius_vox: int = 6) -> np.ndarray:
        """Snap a point to the nearest any-pose-feasible free voxel center
        (within max_radius_vox); near-equidistant candidates are tie-broken
        by ESDF clearance."""
        gm = self.gridmap
        occ = gm.occ.cpu().numpy()
        free = ~occ
        if self.feasibility is not None:
            R, P = self.feasibility.shape[:2]
            free = free & self.feasibility.reshape(R * P, *occ.shape).any(
                axis=0)
        p = np.asarray(p, dtype=np.float64)
        idx = gm.world_to_index(
            torch.as_tensor(p, device=gm.origin.device)).cpu().numpy()
        if (idx < 0).any() or (idx >= np.array(occ.shape)).any():
            return p
        if free[tuple(idx)]:
            return p
        r = max_radius_vox
        lo = np.maximum(idx - r, 0)
        hi = np.minimum(idx + r + 1, occ.shape)
        sub = free[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        cands = np.argwhere(sub) + lo
        if len(cands) == 0:
            return p
        d = np.linalg.norm(cands - idx, axis=1)
        near = d <= d.min() + 1.0
        cands, d = cands[near], d[near]
        if len(cands) > 1:
            if gm.esdf is None:
                gm = gm.with_esdf()
                self.gridmap = gm
            clr = gm.esdf.cpu().numpy()[tuple(cands.T)]
            best = cands[np.argmax(clr - 1e-6 * d)]
        else:
            best = cands[0]
        return gm.index_to_world(
            torch.as_tensor(best, device=gm.origin.device)).cpu().numpy()

    # -- full plan (ref targetRcvCallBack) -----------------------------------
    def plan(self, start, goal, max_iters: Optional[int] = None,
             start_vel=None, start_acc=None, monitor=None) -> PlanResult:
        """Plan from ``start`` to rest at ``goal``; ``max_iters`` caps each
        back-end solve (default: ``conf.max_iterations``).  start_vel and
        start_acc are the head state's derivative rows (default: rest): a
        closed loop replans from the commanded state so the new trajectory
        continues the flight smoothly.  ``monitor``: an optional
        utils.monitor.OptiMonitor streaming each back-end solve's cost
        breakdowns (the first solve and the safety re-plans, one
        ``begin_solve`` each)."""
        if self.gridmap is None:
            raise RuntimeError("call set_map first")
        with obs.span("plan"):
            return self._plan(start, goal, max_iters, start_vel, start_acc,
                              monitor)

    def _plan(self, start, goal, max_iters, start_vel, start_acc,
              monitor) -> PlanResult:
        conf = self.conf
        m: Dict[str, Any] = {}

        start = self.snap_feasible(start)
        goal = self.snap_feasible(goal)

        # 1. front end
        t0 = time.perf_counter()
        pk = self.pose_kernels
        with obs.span("plan.front_end"):
            fr = astar_se3(self.gridmap, start, goal, self.feasibility,
                           None if pk is None else pk.rolls.cpu().numpy(),
                           None if pk is None else pk.pitches.cpu().numpy())
        m["front_end_s"] = time.perf_counter() - t0
        m["expanded"] = fr.expanded
        if not fr.success:
            return PlanResult(False, metrics=m)

        # 2. waypoints, resampled to the next bucket size
        idxs = subsample_waypoints(fr.path, conf.occupancy_resolution,
                                   conf.traj_parlength)
        n_q = len(idxs)
        buckets = [b for b in conf.piece_buckets if b >= n_q]
        if buckets and buckets[0] != n_q:
            Q, wp_rolls, wp_pitches = _resample_by_arclength(
                fr.path, buckets[0], fr.rolls, fr.pitches)
        else:
            Q = fr.path[idxs]
            wp_rolls, wp_pitches = fr.rolls[idxs], fr.pitches[idxs]
        N = len(Q) + 1
        m["n_pieces"] = N

        # attitude references need the pose kernels' (roll, pitch) poses
        rot_refs = None
        if (pk is not None and conf.weight_ar > 0.0
                and (np.abs(wp_rolls).max(initial=0.0) > 1e-9
                     or np.abs(wp_pitches).max(initial=0.0) > 1e-9)):
            rot_refs = self._t(_rp_to_rot(wp_rolls, wp_pitches))
            m["attitude_refs"] = True

        # 3. obstacle gather
        t0 = time.perf_counter()
        bd = conf.kernel_bd
        with obs.span("plan.gather"):
            pts, mask = aabb.gather_aabb_points(
                self._host_map, Q, (bd / 3, bd / 3, bd / 3),
                offset=conf.offsetAABBbox,
                max_points=conf.max_obstacle_points)
        m["aabb_s"] = time.perf_counter() - t0
        m["parallel_points_num"] = int(mask.sum())

        head_np = np.zeros((3, 3))
        head_np[:, 0] = start
        if start_vel is not None:
            head_np[:, 1] = start_vel
        if start_acc is not None:
            head_np[:, 2] = start_acc
        tail_np = np.zeros((3, 3))
        tail_np[:, 0] = goal
        head, tail = self._t(head_np), self._t(tail_np)
        T0 = torch.full((N,), conf.inittime, dtype=self.dtype,
                        device=self.device)

        # 4. mid end
        t0 = time.perf_counter()
        with obs.span("plan.mid_end") as sp:
            ori_traj, opt_x, mid_res = midend.get_ori_traj(
                conf, head, tail, self._t(Q), T0, rot_refs=rot_refs)
            sp.set(iterations=mid_res.n_iters, evaluations=mid_res.n_evals,
                   trials=mid_res.n_trials)
        m["mid_end_s"] = time.perf_counter() - t0
        m["mid_end_iters"] = mid_res.n_iters
        m["mid_end_evals"] = mid_res.n_evals

        # 5. back end
        t0 = time.perf_counter()
        tau, q_ws = backend.unpack(opt_x, N)
        solve = dict(max_iters=max_iters, rot_refs=rot_refs,
                     monitor=monitor, device=self.device, dtype=self.dtype)
        with obs.span("plan.back_end") as sp:
            traj, res = backend.optimize(
                self.shape, conf, head, tail, q_ws, timemap.tau_to_T(tau),
                pts, mask, **solve)
            _solve_counts(sp, 0, res)
        m["back_end_s"] = time.perf_counter() - t0
        m["back_end_iters"] = res.n_iters
        m["back_end_evals"] = res.n_evals

        # 6. safety re-plan: audit the swept volume against every nearby
        # voxel; inject violations (evicting the farthest obstacle slots
        # first) and re-solve warm-started from the current trajectory
        for rnd in range(conf.safety_replan_rounds):
            t0 = time.perf_counter()
            with obs.span("plan.audit"):
                viol, viol_t = self._audit_violations(traj)
            m["audit_s"] = m.get("audit_s", 0.0) + time.perf_counter() - t0
            if viol is None or len(viol) == 0:
                break
            pts_np, mask_np = np.asarray(pts).copy(), np.asarray(mask).copy()
            k = min(len(viol), len(pts_np))
            d_path = np.min(np.linalg.norm(
                pts_np[:, None, :] - Q[None, :, :], axis=-1), axis=1)
            slot_prio = np.where(mask_np, d_path, np.inf)
            evict = np.argsort(-slot_prio, kind="stable")[:k]
            pts_np[evict] = viol[:k]
            mask_np[evict] = True
            pts, mask = pts_np, mask_np
            # seed the injected points' t* from the audit's high-resolution
            # argmin, so the penalty sees them at once
            t_warm_np = np.zeros(len(pts_np))
            t_warm_np[evict] = viol_t[:k]
            q_ws = traj.junction_positions()[1:-1]
            t0 = time.perf_counter()
            with obs.span("plan.back_end") as sp:
                traj, res = backend.optimize(
                    self.shape, conf, head, tail, q_ws, traj.durations, pts,
                    mask, t_warm0=t_warm_np, **solve)
                _solve_counts(sp, rnd + 1, res)
            m["back_end_s"] += time.perf_counter() - t0
            m["back_end_iters"] += res.n_iters
            m["back_end_evals"] += res.n_evals
            m["safety_replans"] = rnd + 1
            m["injected_violations"] = int(k)

        m["final_cost"] = float(res.f)
        m["total_duration"] = float(traj.total_duration)
        return PlanResult(True, traj=traj, path=fr.path, rolls=fr.rolls,
                          pitches=fr.pitches, metrics=m)

    # -- audits --------------------------------------------------------------
    def _audit_sdf(self, traj):
        """Swept SDF at every occupied voxel near the trajectory →
        (points (M,3), sdf (M,), t* (M,)) numpy, or (None,)*3.  The coarse
        time resolution is duration-adaptive (dt ≤ 0.1 s, powers of two)."""
        total = float(traj.total_duration)
        ts = torch.linspace(0.0, total, 64, dtype=traj.durations.dtype,
                            device=self.device)
        with torch.no_grad():
            centers = traj.pos(ts).cpu().numpy()
        pts, mask = aabb.gather_aabb_points(
            self._host_map, centers, (self.conf.kernel_bd / 2,) * 3,
            max_points=self.conf.max_obstacle_points)
        if not mask.any():
            return None, None, None
        live = pts[mask]
        need = total / 0.1
        coarse_n = 64
        while coarse_n < need and coarse_n < 2048:
            coarse_n *= 2
        with torch.no_grad():
            sdf, t_star, _ = sweep_sdf(
                self.shape, traj.detach(), self.params,
                self._t(live, traj.durations.dtype), coarse_n=coarse_n,
                device=self.device)
        return live, sdf.cpu().numpy(), t_star.cpu().numpy()

    def _audit_violations(self, traj, margin: float = 1e-3):
        """(voxel centers, argmin times) whose swept SDF ≤ margin, worst
        first; when any voxel violates, the whole grazing neighbourhood
        (sdf ≤ safety_hor/2) is returned."""
        live, sdf, t_star = self._audit_sdf(traj)
        if live is None:
            return None, None
        if not (sdf <= margin).any():
            return live[:0], t_star[:0]
        near = sdf <= max(float(self.conf.safety_hor) * 0.5, margin)
        order = np.argsort(sdf[near], kind="stable")
        return live[near][order], t_star[near][order]

    def audit_collision(self, traj, n_samples: int = 400) -> float:
        """Minimum swept SDF over all occupied voxels near the trajectory.
        ``n_samples`` is accepted as the JAX package's signature has it and
        is not read: the audit's coarse scan is duration-adaptive."""
        live, sdf, _ = self._audit_sdf(traj)
        if live is None:
            return float("inf")
        return float(sdf.min())
