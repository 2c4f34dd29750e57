"""The occupancy grid of an obstacle cloud (every voxel of the cloud's
bounding box that holds at least ``threshold`` points is occupied) and the
occupied voxel centres near a trajectory, in numpy."""

from __future__ import annotations

import numpy as np


class Occupancy:
    def __init__(self, cloud: np.ndarray, res: float, threshold: int):
        cloud = np.asarray(cloud, dtype=np.float64)
        self.origin = cloud.min(axis=0)
        self.res = float(res)
        self.size = np.maximum(np.ceil(
            (cloud.max(axis=0) - self.origin) / res).astype(int), 1)
        idx = np.floor((cloud - self.origin) / res).astype(int)
        idx = idx[np.all((idx >= 0) & (idx < self.size), axis=1)]
        counts = np.zeros(tuple(self.size), dtype=np.int64)
        np.add.at(counts, tuple(idx.T), 1)
        self.occ = counts >= threshold

    def center(self, idx):
        return self.origin + (np.asarray(idx) + 0.5) * self.res

    def free_center(self, p) -> bool:
        """Whether p lies in a free voxel inside the grid."""
        i = np.floor((np.asarray(p) - self.origin) / self.res).astype(int)
        return bool(np.all((i >= 0) & (i < self.size))
                    and not self.occ[tuple(i)])

    def off_grid(self, pts, tol: float = 1e-4) -> int:
        """How many of pts are not the centre of an occupied voxel."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 3)
        i = np.floor((pts - self.origin) / self.res).astype(int)
        inside = np.all((i >= 0) & (i < self.size), axis=1)
        ic = np.clip(i, 0, self.size - 1)
        on = inside & self.occ[tuple(ic.T)] & np.all(
            np.abs(pts - self.center(ic)) <= tol, axis=1)
        return int((~on).sum())

    def near(self, centers, half: float) -> np.ndarray:
        """Occupied voxel centres in the boxes of half-edge ``half`` around
        each of ``centers`` (the voxels the boxes touch), each once."""
        keep = np.zeros_like(self.occ)
        for c in np.atleast_2d(centers):
            lo = np.clip(np.floor((c - half - self.origin) / self.res)
                         .astype(int), 0, self.size - 1)
            hi = np.clip(np.ceil((c + half - self.origin) / self.res)
                         .astype(int), 0, self.size - 1)
            keep[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
        return self.center(np.argwhere(keep & self.occ))
