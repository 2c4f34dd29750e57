"""The back end's obstacle points of a plan, gathered again from the plan's
front-end path by the upstream planner's rule (plan_manager.cpp): interior
waypoints every ``traj_parlength`` metres of path, resampled by arclength
to the next allowed piece count, then every occupied voxel centre in the
boxes of half-edge kernel_size x resolution / 3 around each waypoint, each
once, the nearest to the waypoints kept when there are more than
``max_obstacle_points``."""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.occupancy import Occupancy


def waypoints(path: np.ndarray, res: float, parlength: float,
              buckets) -> np.ndarray:
    """The interior waypoints of a front-end path (n, 3)."""
    path = np.asarray(path, dtype=np.float64)
    n = len(path)
    pl = parlength
    gap = math.ceil(pl / res)
    while gap >= n - 1 and gap > 1:
        pl /= 1.5
        gap = math.ceil(pl / res)
    idx = np.arange(gap, n - 1, gap)
    fit = [b for b in buckets if b >= len(idx)]
    if not fit or fit[0] == len(idx):
        return path[idx]
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1] if s[-1] > 0 else 1.0
    targets = np.linspace(0.0, total, fit[0] + 2)[1:-1]
    return np.stack([np.interp(targets, s, path[:, ax]) for ax in range(3)],
                    -1)


def obstacle_points(occ: Occupancy, path: np.ndarray, settings: dict,
                    gather: dict) -> np.ndarray:
    """The plan's first back-end solve's obstacle points (M, 3)."""
    res = float(settings["occupancy_resolution"])
    q = waypoints(path, res, gather["traj_parlength"], gather["piece_buckets"])
    half = settings["kernel_size"] * res / 3.0
    pts = occ.near(q + np.asarray(gather["offset"], dtype=np.float64), half)
    cap = int(settings["max_obstacle_points"])
    if len(pts) > cap:
        d = np.linalg.norm(pts[:, None, :] - q[None, :, :], axis=-1).min(1)
        pts = pts[np.argsort(d, kind="stable")[:cap]]
    return pts


def set_gap(occ: Occupancy, a: np.ndarray, b: np.ndarray) -> int:
    """How many voxels lie in one of two sets of voxel centres and not the
    other."""
    def keys(p):
        i = np.floor((np.asarray(p).reshape(-1, 3) - occ.origin) / occ.res)
        return {tuple(v) for v in i.astype(np.int64)}
    return len(keys(a) ^ keys(b))
