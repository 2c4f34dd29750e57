"""Swept-volume surface extraction (counterpart of
``isdf_tpu/viz/swept_mesh.py``; the reference's ``sw_calculate``,
src/swept_volume/src/sw_calculate.cpp:5 and sw_manager.hpp:1078-1193).

The swept SDF is evaluated on the whole dense grid in one device pass per
65,536-point chunk: the cold ``sweep_sdf``, so K1 (sweep/fused_zoom.py) for
an analytic body, at one lane a point (a chunk is above
``fused_zoom.LANES_MAX_POINTS``), or K3 (sweep/grid_zoom.py) for a mesh
robot.  The field comes back to the host in float64 (float32 on the card),
and marching tetrahedra run there: the C++ core in
``native/marching_cubes.cpp`` through ``isdf_torch.native``, or, where no
compiler exists, the Python twin below.  ``PY_TWIN_CALLS`` counts the
twin's runs.
"""

from __future__ import annotations

import numpy as np
import torch

from isdf_torch import native
from isdf_torch.device import resolve_device
from isdf_torch.sweep import sweep_sdf

# runs of the Python twin of the marching tetrahedra since the caller last
# set it to 0
PY_TWIN_CALLS = 0


def grid_points(origin, size, resolution: float) -> np.ndarray:
    """The (X·Y·Z, 3) float64 voxel positions origin + resolution·index, x
    slowest, as ``sdf_volume`` sweeps them."""
    X, Y, Z = size
    xs = origin[0] + np.arange(X) * resolution
    ys = origin[1] + np.arange(Y) * resolution
    zs = origin[2] + np.arange(Z) * resolution
    return np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                    axis=-1).reshape(-1, 3)


def sdf_volume(shape, traj, params, origin, size, resolution: float,
               batch: int = 65536, device=None) -> np.ndarray:
    """Dense swept-SDF grid: the (X, Y, Z) float64 field over
    origin + resolution·index, swept on ``device`` (default: the CUDA card)
    in chunks of ``batch`` points, in the trajectory's dtype."""
    dev = resolve_device(device)
    pts = grid_points(origin, size, resolution)
    traj = traj.detach()
    p = torch.as_tensor(pts, dtype=traj.coeffs.dtype, device=dev)
    out = torch.empty(len(pts), dtype=p.dtype, device=dev)
    with torch.no_grad():
        for i in range(0, len(pts), batch):
            out[i:i + batch] = sweep_sdf(shape, traj, params,
                                         p[i:i + batch], device=dev)[0]
    return out.cpu().double().numpy().reshape(size)


def _auto_bounds(traj, shape, resolution, margin=0.5):
    ts = np.linspace(0.0, float(traj.total_duration), 128)
    dur = traj.durations
    with torch.no_grad():
        pos = traj.pos(torch.as_tensor(ts, dtype=dur.dtype,
                                       device=dur.device)).cpu().numpy()
    r = max(shape.bounds) + margin
    lo = pos.min(axis=0) - r
    hi = pos.max(axis=0) + r
    size = np.ceil((hi - lo) / resolution).astype(int) + 1
    return lo, tuple(int(s) for s in size)


def swept_volume_mesh(shape, traj, params, resolution: float = 0.2,
                      iso: float = 0.0, device=None) -> np.ndarray:
    """Triangle soup (T, 3, 3) of the swept volume's boundary (ref
    calculateSwept, sw_manager.hpp:225), swept on ``device``."""
    global PY_TWIN_CALLS
    origin, size = _auto_bounds(traj, shape, resolution)
    field = sdf_volume(shape, traj, params, origin, size, resolution,
                       device=device)
    tris = native.marching_tetrahedra(field, origin, resolution, iso)
    if tris is None:
        PY_TWIN_CALLS += 1
        tris = _marching_tetrahedra_py(field, origin, resolution, iso)
    return tris


# --- the Python twin of native/marching_cubes.cpp: the same 6-tetrahedra
# decomposition, cell order and triangle vertex order ----------------------
_TETS = [
    (0, 5, 1, 6), (0, 1, 3, 6), (0, 3, 2, 6),
    (0, 2, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
]


def _marching_tetrahedra_py(field, origin, res, iso=0.0) -> np.ndarray:
    X, Y, Z = field.shape
    corners = np.array(
        [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)])
    tris = []

    def lerp(pa, pb, va, vb):
        t = np.clip((iso - va) / (vb - va), 0.0, 1.0)
        return pa + t * (pb - pa)

    for x in range(X - 1):
        for y in range(Y - 1):
            for z in range(Z - 1):
                vals = np.array(
                    [field[x + c[0], y + c[1], z + c[2]] for c in corners])
                if vals.min() >= iso or vals.max() < iso:
                    continue
                pos = np.asarray(origin) + (np.array([x, y, z])
                                            + corners) * res
                for tet in _TETS:
                    tv = vals[list(tet)]
                    tp = pos[list(tet)]
                    inside = [i for i in range(4) if tv[i] < iso]
                    outside = [i for i in range(4) if tv[i] >= iso]
                    if not inside or not outside:
                        continue
                    if len(inside) == 1:
                        i0 = inside[0]
                        tris.append([lerp(tp[i0], tp[o], tv[i0], tv[o])
                                     for o in outside])
                    elif len(inside) == 3:
                        o0 = outside[0]
                        a, b, c = (lerp(tp[o0], tp[i], tv[o0], tv[i])
                                   for i in inside)
                        tris.append([a, c, b])
                    else:
                        i0, i1 = inside
                        o0, o1 = outside
                        a = lerp(tp[i0], tp[o0], tv[i0], tv[o0])
                        b = lerp(tp[i0], tp[o1], tv[i0], tv[o1])
                        c = lerp(tp[i1], tp[o1], tv[i1], tv[o1])
                        d = lerp(tp[i1], tp[o0], tv[i1], tv[o0])
                        tris.append([a, b, c])
                        tris.append([a, c, d])
    return np.asarray(tris) if tris else np.zeros((0, 3, 3))
