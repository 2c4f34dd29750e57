"""Obstacle-point gathering around trajectory waypoints.

Mirrors ``PCSmapManager::getPointsInAABB`` / ``getPointsInAABBOutOfLastOne``
(ref src/map_manager/include/map_manager/PCSmap_manager.h:148-257): collect
the centers of occupied voxels inside axis-aligned boxes around each
subsampled waypoint, de-duplicated across consecutive boxes — these become
the back end's ``parallel_points``.

TPU twist: the result is padded to a **static** budget (points, mask) so the
downstream swept-SDF penalty is a fixed-shape vmap; the gather itself runs on
host once per plan (same as the reference, plan_manager.cpp:232-254).

Copied unchanged from ``isdf_tpu/world/aabb.py`` (numpy only).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gather_aabb_points(
    gridmap,
    waypoints: np.ndarray,
    half_extents: Tuple[float, float, float],
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_points: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied voxel centers within AABBs centered at waypoints+offset.

    Returns (points (max_points, 3) float, mask (max_points,) bool); points
    beyond the actual count are repeated-padded far away with mask False.
    """
    occ = np.asarray(gridmap.occ)
    origin = np.asarray(gridmap.origin)
    res = float(gridmap.resolution)
    size = np.array(occ.shape)
    half = np.asarray(half_extents, dtype=np.float64)
    off = np.asarray(offset, dtype=np.float64)

    seen = set()
    out = []
    for wp in np.atleast_2d(waypoints):
        lo = np.floor((wp + off - half - origin) / res).astype(int)
        hi = np.ceil((wp + off + half - origin) / res).astype(int)
        lo = np.clip(lo, 0, size - 1)
        hi = np.clip(hi, 0, size - 1)
        sub = occ[lo[0] : hi[0] + 1, lo[1] : hi[1] + 1, lo[2] : hi[2] + 1]
        idx = np.argwhere(sub) + lo
        for t in map(tuple, idx):
            if t not in seen:
                seen.add(t)
                out.append(t)

    n = len(out)
    pts = np.full((max_points, 3), 1e6, dtype=np.float64)
    mask = np.zeros(max_points, dtype=bool)
    if n:
        arr = np.asarray(out, dtype=np.float64)
        world = origin + (arr + 0.5) * res
        if n > max_points:
            # over budget: keep the voxels CLOSEST to the waypoint path —
            # truncation must drop far voxels (weak penalty contributors),
            # never near ones (the reference uses all voxels unbounded,
            # plan_manager.cpp:246-254; a static budget needs a priority).
            wps = np.atleast_2d(waypoints)
            dmin = np.full(n, np.inf)
            for i in range(0, n, 65536):
                blk = world[i : i + 65536]
                d = np.linalg.norm(blk[:, None, :] - wps[None, :, :], axis=-1)
                dmin[i : i + 65536] = d.min(axis=1)
            keep = np.argsort(dmin, kind="stable")[:max_points]
            world = world[keep]
            n = max_points
        pts[:n] = world
        mask[:n] = True
    return pts, mask
