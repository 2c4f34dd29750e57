"""SE(2) planar planning — the paper's 2-D experiments (counterpart of
``isdf_tpu/plan/planar.py``): a circle robot with its rotation decoupled
(demo 7) and a polygon whose yaw is optimized (demo 8).

MINCO optimizes (x, y, ψ) jointly: the third trajectory coordinate is the
yaw (core/flatness.PlanarPose), and the swept-volume penalty (K1, or K3 for a
grid shape) and the dynamic penalties switch with the pose map.  The front
end is plain occupancy A* on a one-layer grid, inflated by the body's
footprint; its path tangent seeds the yaw references.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from isdf_torch.config import Config
from isdf_torch.core import timemap
from isdf_torch.core.flatness import PlanarPose
from isdf_torch.device import resolve_device
from isdf_torch.opt import backend, midend
from isdf_torch.search.astar import astar_se3, subsample_waypoints
from isdf_torch.sweep.sweep_sdf import sweep_sdf
from isdf_torch.world.gridmap import GridMap


@dataclass
class PlanarResult:
    success: bool
    traj: Any = None               # PolyTraj over (x, y, ψ)
    path: Optional[np.ndarray] = None
    metrics: Dict[str, Any] = field(default_factory=dict)


def _points3(points2d) -> np.ndarray:
    pts2 = np.asarray(points2d, dtype=np.float64)
    return np.concatenate([pts2, np.zeros((len(pts2), 1))], axis=1)


def plan_planar(conf: Config, shape, points2d: np.ndarray, start_xy,
                goal_xy, yaw_opt: bool = True, start_yaw: float = 0.0,
                goal_yaw: Optional[float] = None,
                max_iters: Optional[int] = None, device=None,
                dtype: torch.dtype = torch.float32) -> PlanarResult:
    """Full planar plan: 2-D A* → MINCO (x, y, ψ) fit → swept-SDF refine.

    points2d: (M, 2) obstacle points in the plane.  yaw_opt=False plans a
    rotation-decoupled robot (ψ pinned to 0, the circle robot); yaw_opt=True
    seeds ψ from the path tangent and optimizes it jointly.  The grid and
    the A* run on the host; the mid end, the back end and the final sweep
    on ``device`` (default: the CUDA card) in ``dtype``."""
    dev = resolve_device(device)
    m: Dict[str, Any] = {}
    params = PlanarPose(z_ref=0.0)

    pts2 = np.asarray(points2d)
    pts3 = _points3(pts2)
    res = conf.occupancy_resolution
    lo = pts2.min(axis=0) - 2.0
    hi = pts2.max(axis=0) + 2.0
    # a one-layer grid: the 3-D A* cannot leave the plane
    gm = GridMap.from_points(
        pts3, (lo[0], hi[0], lo[1], hi[1], -res / 2, res / 2), res,
        conf.sta_threshold, device=dev)

    s3 = np.array([start_xy[0], start_xy[1], 0.0])
    g3 = np.array([goal_xy[0], goal_xy[1], 0.0])
    t0 = time.perf_counter()
    # body-aware front end: inflate by the footprint the body presents in
    # its best orientation (circle: radius; yaw-optimized polygon: its minor
    # half-extent), the planar analogue of the 3-D pose kernels
    b = getattr(shape, "bounds", (0.0, 0.0, 0.0))
    footprint = min(b[0], b[1]) if yaw_opt else max(b[0], b[1])
    infl = int(math.floor(footprint / res))
    gm_search = gm.inflated(infl) if infl > 0 else gm
    fr = astar_se3(gm_search, s3, g3, feasibility=None)
    if not fr.success and infl > 0:     # the body barely fits: less inflated
        fr = astar_se3(gm.inflated(infl - 1) if infl > 1 else gm, s3, g3,
                       feasibility=None)
    m["front_end_s"] = time.perf_counter() - t0
    if not fr.success:
        return PlanarResult(False, metrics=m)

    idxs = subsample_waypoints(fr.path, conf.occupancy_resolution,
                               conf.traj_parlength)
    Q_xy = fr.path[idxs][:, :2]
    N = len(Q_xy) + 1
    m["n_pieces"] = N

    # yaw references from the path tangent (the natural attitude of a
    # forward-moving polygon), unwrapped so MINCO sees a continuous signal
    if yaw_opt:
        d = np.diff(fr.path[:, :2], axis=0)
        tang = np.arctan2(d[:, 1], d[:, 0])
        tang = np.concatenate([tang, tang[-1:]])
        yaw_ref = np.unwrap(tang[idxs])
        goal_psi = float(np.unwrap([start_yaw] + list(tang))[-1]) \
            if goal_yaw is None else goal_yaw
    else:
        yaw_ref = np.zeros(len(idxs))
        goal_psi = 0.0
    Q = np.concatenate([Q_xy, yaw_ref[:, None]], axis=1)

    def on(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    head_np = np.zeros((3, 3))
    head_np[:, 0] = [s3[0], s3[1], start_yaw]
    tail_np = np.zeros((3, 3))
    tail_np[:, 0] = [g3[0], g3[1], goal_psi]
    head, tail = on(head_np), on(tail_np)
    T0 = torch.full((N,), conf.inittime, dtype=dtype, device=dev)

    # obstacle set: every occupied voxel near the path (2-D maps are small
    # enough to take them all up to the point budget)
    occ_pts = gm.occupied_centers()
    if len(occ_pts) > conf.max_obstacle_points:
        d = np.min(np.linalg.norm(
            occ_pts[:, None, :2] - fr.path[None, ::4, :2], axis=-1), axis=1)
        occ_pts = occ_pts[np.argsort(d)[:conf.max_obstacle_points]]
    P = conf.max_obstacle_points
    pts_pad = np.zeros((P, 3))
    mask = np.zeros(P, bool)
    pts_pad[:len(occ_pts)] = occ_pts
    mask[:len(occ_pts)] = True
    m["parallel_points_num"] = int(mask.sum())

    # mid end: the plain MINCO waypoint fit of (x, y, ψ)
    t0 = time.perf_counter()
    _, opt_x, mid_res = midend.get_ori_traj(conf, head, tail, on(Q), T0,
                                            params=params)
    m["mid_end_s"] = time.perf_counter() - t0
    m["mid_end_iters"] = mid_res.n_iters
    m["mid_end_evals"] = mid_res.n_evals

    # back end under the planar pose map
    t0 = time.perf_counter()
    tau, q_ws = backend.unpack(opt_x, N)
    traj, bres = backend.optimize(
        shape, conf, head, tail, q_ws, timemap.tau_to_T(tau), pts_pad, mask,
        max_iters=max_iters, params=params, device=dev, dtype=dtype)
    m["back_end_s"] = time.perf_counter() - t0
    m["back_end_iters"] = bres.n_iters
    m["back_end_evals"] = bres.n_evals
    m["final_cost"] = float(bres.f)
    m["total_duration"] = float(traj.total_duration)

    t0 = time.perf_counter()
    with torch.no_grad():
        sdf, _, _ = sweep_sdf(shape, traj.detach(), params, on(occ_pts),
                              device=dev)
    m["min_swept_sdf"] = float(torch.min(sdf))
    m["audit_s"] = time.perf_counter() - t0
    return PlanarResult(True, traj=traj, path=fr.path, metrics=m)


def audit_planar(shape, traj, points2d, device=None) -> float:
    """Min swept SDF over the 2-D obstacle points (one cold sweep)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(_points3(points2d), dtype=traj.durations.dtype,
                          device=dev)
    with torch.no_grad():
        sdf, _, _ = sweep_sdf(shape, traj.detach(), PlanarPose(z_ref=0.0),
                              pts, device=dev)
    return float(torch.min(sdf))
