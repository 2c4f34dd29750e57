"""Occupancy grids and Euclidean SDFs of the environment (counterpart of
``isdf_tpu/world/gridmap.py``).

Point cloud → boolean voxel grid with a hit-count threshold; the ESDF is the
separable squared distance transform written as a dense min-plus reduction
per axis, d[i] = min_j (f[j] + (i−j)²) — the same result as the reference's
lower-envelope scan, with no serial loop.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from isdf_torch.device import resolve_device


@dataclass(frozen=True)
class GridMap:
    occ: torch.Tensor                  # (X, Y, Z) bool occupancy
    origin: torch.Tensor               # (3,) world coords of voxel (0,0,0) corner
    resolution: float
    esdf: Optional[torch.Tensor] = None    # (X, Y, Z) signed distance

    @staticmethod
    def from_points(points: np.ndarray,
                    bounds: Optional[Tuple[float, ...]] = None,
                    resolution: float = 0.15, sta_threshold: int = 1,
                    pad: float = 0.0, device=None) -> "GridMap":
        """Point cloud → occupancy (ref PCSmap_manager.cpp:106-181).
        bounds = (xmin, xmax, ymin, ymax, zmin, zmax); None measures the
        cloud's own bounding box (+pad).  Built on the host, then moved to
        ``device`` (default: the CUDA card)."""
        if bounds is None:
            p = np.asarray(points)
            lo, hi = p.min(axis=0) - pad, p.max(axis=0) + pad
            bounds = (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])
        bounds = np.asarray(bounds, dtype=np.float64)
        origin = bounds[[0, 2, 4]]
        size = np.maximum(
            np.ceil((bounds[[1, 3, 5]] - origin) / resolution).astype(int), 1)
        idx = np.floor((np.asarray(points) - origin) / resolution).astype(int)
        ok = np.all((idx >= 0) & (idx < size), axis=1)
        idx = idx[ok]
        counts = np.zeros(tuple(size), dtype=np.int32)
        np.add.at(counts, (idx[:, 0], idx[:, 1], idx[:, 2]), 1)
        occ = counts >= sta_threshold
        device = resolve_device(device)
        return GridMap(occ=torch.as_tensor(occ, device=device),
                       origin=torch.as_tensor(origin, device=device),
                       resolution=float(resolution))

    @property
    def shape(self):
        return tuple(self.occ.shape)

    def world_to_index(self, p: torch.Tensor) -> torch.Tensor:
        return torch.floor((p - self.origin) / self.resolution).to(torch.int64)

    def index_to_world(self, idx):
        """Voxel center (ref GridMap3D.h getGridCubeCenter) of indices
        (..., 3): a tensor gives a tensor on the map's device, a numpy
        array a numpy array."""
        if isinstance(idx, np.ndarray):
            origin = self.origin.cpu().numpy()
            return origin + (idx.astype(origin.dtype) + 0.5) * self.resolution
        return self.origin + (idx.to(self.origin.dtype) + 0.5) * self.resolution

    def is_valid_index(self, idx: torch.Tensor) -> torch.Tensor:
        size = torch.as_tensor(self.occ.shape, device=idx.device)
        return torch.all((idx >= 0) & (idx < size), dim=-1)

    def is_occupied_index(self, idx: torch.Tensor) -> torch.Tensor:
        """Occupancy at voxel indices (..., 3); outside the grid is free."""
        idx = idx.to(self.occ.device)
        hi = torch.as_tensor(self.occ.shape, device=idx.device) - 1
        idc = torch.minimum(torch.clamp(idx, min=0), hi)
        inside = self.is_valid_index(idx)
        return inside & self.occ[idc[..., 0], idc[..., 1], idc[..., 2]]

    def is_occupied(self, p: torch.Tensor) -> torch.Tensor:
        return self.is_occupied_index(self.world_to_index(p))

    def occupied_centers(self) -> np.ndarray:
        """World coordinates of every occupied voxel's center (host)."""
        idx = np.argwhere(self.occ.cpu().numpy())
        return self.origin.cpu().numpy() + (idx + 0.5) * self.resolution

    def inflated(self, radius_vox: int) -> "GridMap":
        """Occupancy dilated by a box of ±radius_vox voxels (ref
        PCSmap_manager's bit-kernel inflation), on the map's device."""
        k = 2 * radius_vox + 1
        occ = self.occ.to(torch.float32)[None, None]
        out = torch.nn.functional.max_pool3d(occ, k, stride=1,
                                             padding=radius_vox)
        return replace(self, occ=out[0, 0] > 0.5)

    def sdf_value(self, p: torch.Tensor) -> torch.Tensor:
        """Trilinear ESDF interpolation at world points (..., 3), clamped at
        the border (ref GridMap3D.h:114-150); differentiable in p."""
        return _trilinear(self.esdf, self.origin, self.resolution, p)

    def sdf_grad(self, p: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.sdf_value(q).sum(), q)
        return g

    def sdf_value_grad(self, p: torch.Tensor):
        return self.sdf_value(p), self.sdf_grad(p)

    def cpu(self) -> "GridMap":
        """The same map on the host (the numpy-only obstacle gather reads it
        through ``np.asarray``)."""
        return replace(self, occ=self.occ.cpu(), origin=self.origin.cpu(),
                       esdf=None if self.esdf is None else self.esdf.cpu())

    def with_esdf(self) -> "GridMap":
        d2_out = _edt2(self.occ)                   # squared dist to occupied
        d2_in = _edt2(~self.occ)                   # squared dist to free
        esdf = (torch.sqrt(d2_out) - torch.sqrt(d2_in)) * self.resolution
        return replace(self, esdf=esdf)


def _dt_1d_minplus(f: torch.Tensor) -> torch.Tensor:
    """Exact 1-D squared distance transform along the last axis,
    d[i] = min_j f[j] + (i−j)², as a dense (n, n) min-reduction."""
    n = f.shape[-1]
    i = torch.arange(n, device=f.device)
    d = ((i[:, None] - i[None, :]).to(f.dtype)) ** 2
    return torch.min(f[..., None, :] + d, dim=-1).values


def _edt2(occ: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance (in voxels) to the nearest True voxel."""
    big = 1e12
    f = torch.where(occ, 0.0, big).to(torch.float32)
    f = _dt_1d_minplus(f)                             # along z
    f = _dt_1d_minplus(f.movedim(1, 2))               # along y
    f = _dt_1d_minplus(f.movedim(0, 2))               # along x
    # axes are now (y, z, x) → restore (x, y, z)
    f = f.movedim(2, 0).movedim(2, 1)
    return torch.clamp(f, max=big)


def _trilinear(field: torch.Tensor, origin: torch.Tensor, resolution: float,
               p: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a scalar voxel field at world points
    (..., 3), clamped at the border; differentiable in p."""
    g = (p - origin.to(p.dtype)) / resolution - 0.5
    size = torch.as_tensor(field.shape, device=p.device)
    g = torch.minimum(torch.clamp(g, min=0.0),
                      (size - 1).to(g.dtype) - 1e-6)
    i0 = torch.minimum(torch.clamp(torch.floor(g).to(torch.int64), min=0),
                       size - 2)
    frac = g - i0.to(g.dtype)
    f = field.to(p.dtype)

    def gather(ox, oy, oz):
        return f[i0[..., 0] + ox, i0[..., 1] + oy, i0[..., 2] + oz]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c000, c100 = gather(0, 0, 0), gather(1, 0, 0)
    c010, c110 = gather(0, 1, 0), gather(1, 1, 0)
    c001, c101 = gather(0, 0, 1), gather(1, 0, 1)
    c011, c111 = gather(0, 1, 1), gather(1, 1, 1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz
