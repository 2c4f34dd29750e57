"""SE(3)-aware A* front end (counterpart of ``isdf_tpu/search/astar.py``).

26-connected grid A* with the diagonal-distance heuristic ×(1+1e-3), edge
cost = Euclidean step, and a per-node attitude: an expansion is admissible
only if some (roll, pitch) pose kernel is collision-free there, preferring
the zero pose, else the pose nearest the parent's.  The priority queue is a
host loop over O(1) lookups in the precomputed feasibility volume; the C++
twin in native/astar.cpp runs it when it can be built, this Python loop
otherwise.
"""

from __future__ import annotations

import heapq
import math
from typing import NamedTuple, Optional

import numpy as np

from isdf_torch import native
from isdf_torch.search.pose_kernels import nearest_feasible_pose

_SQRT2, _SQRT3 = math.sqrt(2.0), math.sqrt(3.0)


class AstarResult(NamedTuple):
    success: bool
    path: np.ndarray          # (L, 3) world positions (voxel centers)
    rolls: np.ndarray         # (L,) radians
    pitches: np.ndarray       # (L,) radians
    expanded: int


def _heuristic(d):
    dx, dy, dz = np.abs(d)
    dmin, dmax = min(dx, dy, dz), max(dx, dy, dz)
    dmid = dx + dy + dz - dmin - dmax
    return (_SQRT3 * dmin + _SQRT2 * (dmid - dmin) + (dmax - dmid)) * (1 + 1e-3)


_NBRS = [
    (i, j, k)
    for i in (-1, 0, 1)
    for j in (-1, 0, 1)
    for k in (-1, 0, 1)
    if (i, j, k) != (0, 0, 0)
]
_NBR_COST = [math.sqrt(i * i + j * j + k * k) for (i, j, k) in _NBRS]


def _fail(expanded=0) -> AstarResult:
    return AstarResult(False, np.zeros((0, 3)), np.zeros(0), np.zeros(0),
                       expanded)


def astar_se3(
    gridmap,
    start: np.ndarray,
    goal: np.ndarray,
    feasibility: Optional[np.ndarray] = None,
    rolls: Optional[np.ndarray] = None,
    pitches: Optional[np.ndarray] = None,
    max_expansions: int = 2_000_000,
    use_native: bool = True,
) -> AstarResult:
    """A* search; with ``feasibility`` (R, P, X, Y, Z, host bool array) the
    search is pose-aware, else plain occupancy A*."""
    occ = gridmap.occ.cpu().numpy()
    origin = gridmap.origin.cpu().numpy()
    res = float(gridmap.resolution)
    size = occ.shape

    def to_idx(p):
        return tuple(np.floor((np.asarray(p) - origin) / res).astype(int))

    def in_map(idx):
        return all(0 <= idx[a] < size[a] for a in range(3))

    s_idx, g_idx = to_idx(start), to_idx(goal)
    if not (in_map(s_idx) and in_map(g_idx)):
        return _fail()

    if use_native:
        nat = native.astar_native(occ, feasibility, s_idx, g_idx,
                                  max_expansions)
        if nat is not None:
            path_idx, pose_idx, expanded = nat
            if path_idx is None:
                return _fail(expanded)
            pts = origin + (path_idx + 0.5) * res
            if feasibility is not None:
                rr = np.asarray(rolls)[pose_idx[:, 0]]
                pp = np.asarray(pitches)[pose_idx[:, 1]]
            else:
                rr = np.zeros(len(path_idx))
                pp = np.zeros(len(path_idx))
            return AstarResult(True, pts, rr, pp, expanded)

    pose_aware = feasibility is not None
    if pose_aware:
        feas = np.asarray(feasibility)
        Rn, Pn = feas.shape[:2]
        any_feas = feas.reshape(Rn * Pn, *size).any(axis=0)
        zero = ((Rn - 1) // 2, (Pn - 1) // 2)

    g_np = np.asarray(g_idx)
    gscore = np.full(size, math.inf)
    came = {}
    pose_of = {}
    closed = np.zeros(size, dtype=bool)

    gscore[s_idx] = 0.0
    pose_of[s_idx] = zero if pose_aware else (0, 0)
    heap = [(_heuristic(np.asarray(s_idx) - g_np), s_idx)]
    expanded = 0

    while heap:
        _, cur = heapq.heappop(heap)
        if closed[cur]:
            continue
        closed[cur] = True
        expanded += 1
        if cur == g_idx or expanded > max_expansions:
            break
        cg = gscore[cur]
        fpose = pose_of.get(cur, (0, 0))
        for (d, ec) in zip(_NBRS, _NBR_COST):
            nb = (cur[0] + d[0], cur[1] + d[1], cur[2] + d[2])
            if not in_map(nb) or closed[nb] or occ[nb]:
                continue
            if pose_aware:
                if not any_feas[nb]:
                    continue
                pose = nearest_feasible_pose(
                    feas[:, :, nb[0], nb[1], nb[2]], fpose)
                if pose is None:
                    continue
            else:
                pose = (0, 0)
            ng = cg + ec
            if ng < gscore[nb]:
                gscore[nb] = ng
                came[nb] = cur
                pose_of[nb] = pose
                heapq.heappush(
                    heap, (ng + _heuristic(np.asarray(nb) - g_np), nb))

    if not closed[g_idx]:
        return _fail(expanded)

    chain = [g_idx]
    while chain[-1] != s_idx:
        chain.append(came[chain[-1]])
    chain.reverse()
    pts = origin + (np.asarray(chain) + 0.5) * res
    if pose_aware:
        rr = np.asarray([float(rolls[pose_of[c][0]]) for c in chain])
        pp = np.asarray([float(pitches[pose_of[c][1]]) for c in chain])
    else:
        rr = np.zeros(len(chain))
        pp = np.zeros(len(chain))
    return AstarResult(True, pts, rr, pp, expanded)


def subsample_waypoints(path: np.ndarray, resolution: float,
                        parlength: float = 3.0):
    """Waypoint subsample every ~parlength meters of path index distance
    (ref plan_manager.cpp:206-245)."""
    path_size = len(path)
    pl = parlength
    gap = math.ceil(pl / resolution)
    while gap >= path_size - 1 and gap > 1:
        pl /= 1.5
        gap = math.ceil(pl / resolution)
    return np.asarray(list(range(gap, path_size - 1, gap)), dtype=int)
