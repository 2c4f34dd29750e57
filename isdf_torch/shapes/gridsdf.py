"""Grid-backed SDF shapes: mesh robots as baked voxel fields (counterpart of
``isdf_tpu/shapes/gridsdf.py``).

The on-device form of the reference's numeric self-SDF map (ref
Shape.hpp:481-600 getonlySDFNum/getonlyGrad1Num: trilinear interpolation of
a precomputed grid).  Only the distance field is stored; the gradient is the
autograd of the trilinear interpolant.  Outside the grid the field falls
back to the distance to the grid's box plus the boundary value (the
reference returns 1e20 there, Shape.hpp:600).

A grid shape has ``spec=None`` and carries its ``GridField``
(sweep/grid_zoom.py) in ``grid``: the swept SDF sends it to K3.
"""

from __future__ import annotations

import numpy as np
import torch

from isdf_torch.core.smoothing import clip
from isdf_torch.device import resolve_device
from isdf_torch.shapes import mesh as meshlib
from isdf_torch.shapes.zoo import SHAPE_REGISTRY, Shape, make_shape
from isdf_torch.sweep.grid_zoom import GridField


def _interp3(field, origin, res, px, py, pz):
    """Component-form trilinear interpolation + outside fallback.

    The field, origin and resolution are cast to the query's dtype, so a
    float32 query stays float32 and a float64 one is interpolated in float64
    (from the float32 field)."""
    dt = px.dtype
    field = field.to(dt)
    o = [torch.as_tensor(origin[i], dtype=dt, device=px.device)
         for i in range(3)]
    res = torch.as_tensor(res, dtype=dt, device=px.device)
    n = field.shape

    def axis(p, i):
        g = (p - o[i]) / res
        gc = clip(g, 0.0, (n[i] - 1) - 1e-5)
        i0 = torch.clamp(torch.floor(gc).to(torch.int64), 0, n[i] - 2)
        return g, i0, gc - i0.to(dt)

    gx, ix, fx = axis(px, 0)
    gy, iy, fy = axis(py, 1)
    gz, iz, fz = axis(pz, 2)

    flat = field.reshape(-1)
    base = (ix * n[1] + iy) * n[2] + iz

    def gat(off):
        return flat[base + off]

    o_x, o_y = n[1] * n[2], n[2]
    c00 = gat(0) * (1 - fx) + gat(o_x) * fx
    c10 = gat(o_y) * (1 - fx) + gat(o_x + o_y) * fx
    c01 = gat(1) * (1 - fx) + gat(o_x + 1) * fx
    c11 = gat(o_y + 1) * (1 - fx) + gat(o_x + o_y + 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    inner = c0 * (1 - fz) + c1 * fz

    # outside fallback: clamp-point value + distance to the grid box
    zero = torch.zeros((), dtype=dt, device=px.device)

    def over(g, i):
        return torch.maximum(g - (n[i] - 1), zero) + torch.minimum(g, zero)

    ov2 = over(gx, 0) ** 2 + over(gy, 1) ** 2 + over(gz, 2) ** 2
    outside = torch.sqrt(ov2 * (res * res) + 1e-12)
    return inner + outside


def _interp(field, origin, res, p):
    return _interp3(field, origin, res, p[..., 0], p[..., 1], p[..., 2])


def grid_shape(name: str, field, origin, resolution, bounds=None,
               device=None) -> Shape:
    """A Shape over a baked SDF field (nx, ny, nz) with grid point (i, j, k)
    at origin + (i, j, k)·resolution; the field lives on ``device`` (default:
    the CUDA card) in float32."""
    grid = GridField.build(field, origin, resolution, resolve_device(device))
    if bounds is None:
        ext = np.asarray(grid.dims) * float(resolution) / 2
        bounds = tuple(float(e) for e in ext)

    def sdf3(px, py, pz):
        return _interp3(grid.field, grid.origin, grid.res, px, py, pz)

    def sdf(p):
        return _interp(grid.field, grid.origin, grid.res, p)

    return Shape(name=name, sdf=sdf, bounds=bounds, sdf3=sdf3, grid=grid)


def mesh_shape(name: str, obj_path: str, poly_params=(0.0,) * 6,
               resolution: float = 0.1, margin: float = 0.6, device=None,
               dtype: torch.dtype = torch.float32) -> Shape:
    """Load an OBJ robot body, apply its yaml pose, bake the SDF grid (in
    ``dtype``, on ``device``, default the CUDA card), and wrap it as a Shape
    (the ``Generalshape`` replacement — ref Shape.cpp:27)."""
    dev = resolve_device(device)
    V, F = meshlib.load_obj(obj_path)
    V = meshlib.transform_mesh(V, poly_params)
    field, origin, res = meshlib.bake_sdf_grid(V, F, resolution, margin,
                                               device=dev, dtype=dtype)
    ext = np.abs(V).max(axis=0)
    return grid_shape(name, field, origin, res, bounds=tuple(ext), device=dev)


def shape_from_config(conf, device=None,
                      dtype: torch.dtype = torch.float32) -> Shape:
    """Shape factory honoring use_objfile_as_body (ref sw_manager initShape):
    the named analytic shape if registered, else the mesh at
    ``conf.inputdata`` baked at ``conf.selfmapresu`` on ``device`` (default:
    the CUDA card), else a Ball."""
    name = (conf.inputdata.rsplit("/", 1)[-1].removesuffix(".obj")
            if conf.inputdata else "")
    if name in SHAPE_REGISTRY:
        return make_shape(name, conf)
    if conf.inputdata:
        return mesh_shape(name or "mesh", conf.inputdata, conf.poly_params,
                          conf.selfmapresu, device=device, dtype=dtype)
    return make_shape("Ball", conf)
