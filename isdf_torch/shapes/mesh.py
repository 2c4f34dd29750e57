"""Mesh → SDF pipeline (counterpart of ``isdf_tpu/shapes/mesh.py``).

The reference computes mesh SDFs with libigl (sign from the fast winding
number, magnitude from an AABB-tree point-triangle distance, ref
src/utils/src/Shape.cpp:103-151) and bakes a dense self-SDF grid it then
samples trilinearly (ref Shape.hpp:361-404 initShape).  As in the JAX
package, only the baked grid is kept and the bake is computed here: the exact
generalized winding number (van Oosterom–Strackee solid angles) and exact
point-triangle distances, as batched tensor operations over (points × faces)
on the given device.

``l_prism`` and ``write_obj`` make the synthetic L-shaped body that stands in
for demo 6's ``Lthick.obj`` (the reference's mesh assets are not in this
repository).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from isdf_torch.device import resolve_device


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ parser: vertices + triangulated faces (fan).

    (ref igl::read_triangle_mesh usage, Shape.cpp:36)"""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces,
                                                           dtype=np.int32)


def write_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    """Write vertices and triangles as an OBJ file (1-based indices) that
    :func:`load_obj` reads back exactly."""
    with open(path, "w") as f:
        for v in np.asarray(V, dtype=np.float64):
            f.write("v " + " ".join(repr(float(c)) for c in v) + "\n")
        for tri in np.asarray(F):
            f.write("f " + " ".join(str(int(i) + 1) for i in tri) + "\n")


def l_prism(arm_x: float = 1.6, arm_y: float = 1.0,
            thick: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    """A thick L: an L-shaped hexagon in the xy-plane (an arm of ``arm_x``
    along x and one of ``arm_y`` along y, each ``thick`` wide) extruded by
    ``thick`` along z, centred on its bounding box → (V (12, 3), F (20, 3)),
    faces outward."""
    t = thick
    ring = np.array([[0.0, 0.0], [arm_x, 0.0], [arm_x, t], [t, t],
                     [t, arm_y], [0.0, arm_y]])             # counter-clockwise
    V = np.concatenate([np.c_[ring, np.zeros(6)], np.c_[ring, np.full(6, t)]])
    V -= np.array([arm_x, arm_y, t]) / 2
    # the hexagon as four triangles fanned from its reflex corner (3)
    cap = [(3, 0, 1), (3, 1, 2), (3, 4, 5), (3, 5, 0)]
    F = [(a + 6, b + 6, c + 6) for a, b, c in cap]          # top, +z
    F += [(a, c, b) for a, b, c in cap]                     # bottom, −z
    for i in range(6):                                       # sides
        j = (i + 1) % 6
        F += [(i, j, j + 6), (i, j + 6, i + 6)]
    return V, np.asarray(F, dtype=np.int32)


def transform_mesh(V: np.ndarray, poly_params) -> np.ndarray:
    """Apply the yaml pose (trans + euler degrees) to vertices
    (ref Shape.cpp:38-52: V ← R·V + t with R = Rz·Ry·Rx)."""
    from isdf_torch.shapes.zoo import _pose_from_poly_params

    t, R = _pose_from_poly_params(poly_params)
    return V @ R.T + t


# --- exact point-triangle distance (vectorized Ericson) ---------------------
def _point_tri_dist_sq(p, a, b, c):
    """Squared distances: p (..., 3) vs one triangle per row (..., 3)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(x):
        return torch.where(x.abs() > 1e-30, x, torch.full_like(x, 1e-30))

    v_ab = torch.clamp(d1 / safe(d1 - d3), 0.0, 1.0)
    v_ac = torch.clamp(d2 / safe(d2 - d6), 0.0, 1.0)
    w_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)

    denom = safe(va + vb + vc)
    v = vb / denom
    w = vc / denom

    # candidate closest points per region
    p_ab = a + v_ab[..., None] * ab
    p_ac = a + v_ac[..., None] * ac
    p_bc = b + w_bc[..., None] * (c - b)
    p_in = a + v[..., None] * ab + w[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    closest = p_in
    for sel, q in ((in_bc, p_bc), (in_ac, p_ac), (in_ab, p_ab), (in_c, c),
                   (in_b, b), (in_a, a)):
        closest = torch.where(sel[..., None], q, closest)
    d = p - closest
    return (d * d).sum(-1)


def _winding_number(p, a, b, c):
    """Generalized winding number at p (M, 3) over triangles (A, 3) — sum of
    signed solid angles / 4π (van Oosterom–Strackee)."""
    ra = a[None] - p[:, None]
    rb = b[None] - p[:, None]
    rc = c[None] - p[:, None]
    la = torch.linalg.norm(ra, dim=-1)
    lb = torch.linalg.norm(rb, dim=-1)
    lc = torch.linalg.norm(rc, dim=-1)
    num = (ra * torch.linalg.cross(rb, rc, dim=-1)).sum(-1)
    den = (la * lb * lc + (ra * rb).sum(-1) * lc + (rb * rc).sum(-1) * la
           + (rc * ra).sum(-1) * lb)
    omega = 2.0 * torch.atan2(num, den)
    return omega.sum(-1) / (4.0 * math.pi)


def _sdf_chunk(p, va, vb, vc):
    d2 = _point_tri_dist_sq(p[:, None, :], va[None], vb[None], vc[None])
    dist = torch.sqrt(d2.min(dim=1).values + 1e-30)
    wn = _winding_number(p, va, vb, vc)
    sign = torch.where(wn > 0.5, -1.0, 1.0).to(dist.dtype)
    return sign * dist


@torch.no_grad()
def mesh_sdf(points: np.ndarray, V: np.ndarray, F: np.ndarray,
             chunk: int = 4096, device=None,
             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Signed distance of arbitrary points to a triangle mesh, computed in
    ``dtype`` on ``device`` (default: the CUDA card) ``chunk`` points at a
    time; sign by winding number > 0.5 (robust to imperfect meshes, the
    principle of libigl's FWN).  Returns a numpy array."""
    dev = resolve_device(device)

    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    va, vb, vc = on(V[F[:, 0]]), on(V[F[:, 1]]), on(V[F[:, 2]])
    out = [_sdf_chunk(on(points[i:i + chunk]), va, vb, vc).cpu().numpy()
           for i in range(0, len(points), chunk)]
    return np.concatenate(out)


def bake_sdf_grid(V: np.ndarray, F: np.ndarray, resolution: float = 0.1,
                  margin: float = 0.5, device=None,
                  dtype: torch.dtype = torch.float32):
    """Dense SDF grid over the mesh bounds + margin (ref initShape's
    num_sdf_map bake, Shape.hpp:361-404), computed in ``dtype`` on
    ``device``.  Returns (grid (X, Y, Z) float32 numpy, origin (3,),
    resolution)."""
    lo = V.min(axis=0) - margin
    hi = V.max(axis=0) + margin
    size = np.ceil((hi - lo) / resolution).astype(int) + 1
    xs = lo[0] + np.arange(size[0]) * resolution
    ys = lo[1] + np.arange(size[1]) * resolution
    zs = lo[2] + np.arange(size[2]) * resolution
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    sdf = mesh_sdf(g, V, F, device=device, dtype=dtype)
    return sdf.reshape(tuple(size)).astype(np.float32), lo, resolution


def face_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Outward unit face normals (ref igl::per_face_normals usage,
    Shape.cpp:20 + hPoly assembly Shape.cpp:66-78)."""
    a, b, c = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    n = np.cross(b - a, c - b)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-30)


def h_poly(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Half-space representation (F, 4): rows (nx, ny, nz, d) with
    n·p + d = 0 on the face plane (ref Generalshape hPoly, Shape.cpp:66-78).
    """
    n = face_normals(V, F)
    p0 = V[F[:, 1]]
    d = -np.sum(n * p0, axis=1)
    return np.concatenate([n, d[:, None]], axis=1)
