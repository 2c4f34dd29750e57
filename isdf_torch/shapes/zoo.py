"""The named robot-shape zoo (counterpart of ``isdf_tpu/shapes/zoo.py``).

Same shapes and parameter values as the reference's Shape.hpp classes.
Every shape carries the yaml pose transform (trans, Rotate) from
``poly_params`` (tx,ty,tz, roll,pitch,yaw in degrees; local query
p_local = Rotateᵀ(p − trans)).  Gradients come from autograd.  Every
shape also carries a ``ShapeSpec`` (shapes/spec.py), the description the
CUDA sweep kernels evaluate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from isdf_torch.shapes import ops
from isdf_torch.shapes import primitives as pr
from isdf_torch.shapes import spec as sp
from isdf_torch.core.smoothing import vabs, vmin


def _pose_from_poly_params(poly_params):
    """(trans, R) from config poly_params (ref Shape.cpp:38-44)."""
    para = list(poly_params) + [0.0] * (6 - len(poly_params))
    t = np.array(para[:3], dtype=np.float64)
    rr, pp, yy = (math.radians(a) for a in para[3:6])
    Rx = np.array(
        [[1, 0, 0], [0, math.cos(rr), -math.sin(rr)],
         [0, math.sin(rr), math.cos(rr)]])
    Ry = np.array(
        [[math.cos(pp), 0, math.sin(pp)], [0, 1, 0],
         [-math.sin(pp), 0, math.cos(pp)]])
    Rz = np.array(
        [[math.cos(yy), -math.sin(yy), 0], [math.sin(yy), math.cos(yy), 0],
         [0, 0, 1]])
    return t, Rz @ Ry @ Rx


@dataclass(frozen=True)
class Shape:
    """A robot body SDF in the body frame (the yaml pose included).

    ``sdf`` maps points (..., 3) to distances (...); ``sdf3`` is the
    component form (px, py, pz) → d; ``spec`` the device description the
    CUDA sweep kernels evaluate (every zoo shape has one; None on a shape
    built by hand means the kernels cannot take it).  A mesh robot
    (shapes/gridsdf.py) has ``spec=None`` and carries its baked voxel field
    in ``grid`` (sweep/grid_zoom.GridField), which the sweep sends to K3."""

    name: str
    sdf: Callable
    bounds: Tuple[float, float, float]
    sdf3: Optional[Callable] = field(default=None, compare=False)
    spec: Optional[sp.ShapeSpec] = field(default=None, compare=False)
    grid: Optional[object] = field(default=None, compare=False)

    def sdf3_fn(self) -> Callable:
        if self.sdf3 is not None:
            return self.sdf3
        return lambda x, y, z: self.sdf(torch.stack([x, y, z], dim=-1))

    def grad(self, p):
        """∂sdf/∂p, shape (..., 3)."""
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            return torch.autograd.grad(self.sdf(q).sum(), q)[0]


def _posed(name, f3, bounds, conf, spec=None) -> Shape:
    """Build a Shape from a component-form SDF (px, py, pz) → d."""
    poly = getattr(conf, "poly_params", (0.0,) * 6) if conf is not None \
        else (0.0,) * 6
    t, R = _pose_from_poly_params(poly)
    if np.allclose(t, 0.0) and np.allclose(R, np.eye(3)):
        g3 = f3
    else:
        g3 = ops.transformed3(f3, R, t)
        spec = None if spec is None else spec.with_pose(R, t)
    return Shape(name=name, sdf=ops.aos(g3), bounds=bounds, sdf3=g3,
                 spec=spec)


def ball(conf=None, radius: float = 1.0) -> Shape:
    return _posed(
        "Ball", lambda x, y, z: pr.sphere_c(x, y, z, radius),
        (radius,) * 3, conf, sp.ball_spec(radius),
    )


def point(conf=None) -> Shape:
    return _posed("Point", pr.point_c, (0.1,) * 3, conf, sp.point_spec())


def torus(conf=None, ring_r: float = 2.5, tube_r: float = 0.3) -> Shape:
    # the reference names these backwards: tubeRadius{2.5} is the ring radius
    b = (ring_r + tube_r, tube_r, ring_r + tube_r)
    return _posed(
        "Torus", lambda x, y, z: pr.torus_c(x, y, z, ring_r, tube_r), b, conf,
        sp.torus_spec(ring_r, tube_r),
    )


def torus_big(conf=None) -> Shape:
    s = torus(conf, ring_r=3.5, tube_r=0.3)
    return Shape("Torus_big", s.sdf, s.bounds, sdf3=s.sdf3, spec=s.spec)


def capped_torus(conf=None) -> Shape:
    # ref Shape.hpp:897: sc = (sin(40), cos(40)) — radians, as written.
    sc = (math.sin(40.0), math.cos(40.0))
    ra, rb = 3.5, 0.3
    b = (ra + rb, ra + rb, rb)
    return _posed(
        "Cappedtorus",
        lambda x, y, z: pr.capped_torus_c(x, y, z, sc, ra, rb), b, conf,
        sp.capped_torus_spec(sc, ra, rb),
    )


def capped_cone(conf=None) -> Shape:
    a, b_, ra, rb = (0.0, 0.0, -1.0), (0.0, 0.0, 1.0), 2.0, 0.8
    return _posed(
        "CappedCone",
        lambda x, y, z: pr.capped_cone_c(x, y, z, a, b_, ra, rb),
        (2.0, 2.0, 1.0),
        conf,
        sp.capped_cone_spec(a, b_, ra, rb),
    )


def rounded_cone(conf=None) -> Shape:
    r1, r2, h = 1.5, 0.6, 4.5
    return _posed(
        "RoundedCone",
        lambda x, y, z: pr.rounded_cone_c(x, y, z, r1, r2, h),
        (r1, r1, h + r2),
        conf,
        sp.rounded_cone_spec(r1, r2, h),
    )


def wireframe_box(conf=None) -> Shape:
    size, th = (1.8, 2.5, 3.5), 0.1
    b = tuple(s / 2 + th for s in size)
    return _posed(
        "WireframeBox",
        lambda x, y, z: pr.wireframe_box_c(x, y, z, size, th), b, conf,
        sp.wireframe_box_spec(size, th),
    )


def _bend_capsule(name, half_len, radius, bounds, conf) -> Shape:
    """A z-capsule of half length ``half_len`` bent linearly towards −x."""
    a, b = (0, 0, -half_len), (0, 0, half_len)
    p0, p1, v = (0, 0, -1.0), (0, 0, 1.0), (-1.0, 0, 0)
    f = ops.bend_linear3(
        lambda x, y, z: pr.capsule_c(x, y, z, a, b, radius), p0, p1, v)
    return _posed(name, f, bounds, conf,
                  sp.bend_linear_spec(p0, p1, v, a, b, radius))


def bend_linear(conf=None) -> Shape:
    return _bend_capsule("BendLinear", 2.0, 0.25, (1.5, 0.5, 2.5), conf)


def bend_linear_big(conf=None) -> Shape:
    return _bend_capsule("BendLinear_big", 3.2, 0.45, (1.7, 0.7, 3.9), conf)


def twist_box(conf=None) -> Shape:
    f = ops.twist3(
        lambda x, y, z: pr.box_c(x, y, z, (1.0, 1.0, 1.0)), math.pi / 6)
    return _posed("TwistBox", f, (1.5, 1.5, 1.0), conf,
                  sp.twist_box_spec(math.pi / 6, (1.0, 1.0, 1.0)))


def bend_box(conf=None) -> Shape:
    f = ops.bend3(lambda x, y, z: pr.box_c(x, y, z, (1.0, 1.0, 1.0)), 0.5)
    return _posed("BendBox", f, (1.6, 1.6, 1.0), conf,
                  sp.bend_box_spec(0.5, (1.0, 1.0, 1.0)))


def table(conf=None) -> Shape:
    # |x|,|y| mirrored union of two boxes given by corner pairs
    a1, b1 = np.array([0.0, 0.0, 0.0]), np.array([3.5, 1.75, 0.7])
    a2, b2 = np.array([2.8, 1.05, 0.0]), np.array([3.5, 1.75, 2.8])
    c1, h1 = ((a1 + b1) / 2).tolist(), (b1 - a1) / 2
    c2, h2 = ((a2 + b2) / 2).tolist(), (b2 - a2) / 2

    def f(x, y, z):
        qx, qy, qz = vabs(x), vabs(y), z
        f1 = pr.box_c(qx - c1[0], qy - c1[1], qz - c1[2], h1)
        f2 = pr.box_c(qx - c2[0], qy - c2[1], qz - c2[2], h2)
        return vmin(f1, f2)

    return _posed("Table", f, (3.5, 1.75, 2.8), conf,
                  sp.table_spec(c1, h1, c2, h2))


def blobby(conf=None) -> Shape:
    """Smooth union of four balls (the shape the reference's Blobby, which
    has no return statement, implies)."""
    balls = ((1.0, 0.0, 0.0, 1.0), (-1.0, 0.0, 0.0, 1.0),
             (0.0, 1.2, 0.0, 0.8), (0.0, 0.0, 1.2, 0.8))
    s1, s2, s3, s4 = (
        (lambda x, y, z, c=c: pr.sphere_c(x - c[0], y - c[1], z - c[2], c[3]))
        for c in balls)
    f = ops.smooth_union3(
        ops.smooth_union3(s1, s2, 0.5), ops.smooth_union3(s3, s4, 0.5), 0.5
    )
    return _posed("Blobby", f, (2.2, 2.2, 2.2), conf,
                  sp.blobby_spec(balls, 0.5))


def trefoil(conf=None) -> Shape:
    """Trefoil knot tube: polar fold + 1.5·θ twist of a rounded 2-D box."""

    def f(x, y, z):
        r, py = 3.5, -z
        a = torch.atan2(y, x)
        qx = torch.sqrt(x * x + y * y + 1e-12) - r
        qy = py

        def rot2d(qx, qy, ang):
            c, s = torch.cos(ang), torch.sin(ang)
            return qx * c + qy * s, qy * c - qx * s

        qx, qy = rot2d(qx, qy, 1.5 * a)
        fold = -math.pi * torch.floor(torch.atan2(qy, qx) / math.pi + 0.5)
        qx, qy = rot2d(qx, qy, fold)
        qx = qx - 1.0
        dx = vabs(qx) - 0.2
        dy = vabs(qy) - 0.2
        zero = torch.zeros_like(dx)
        box2 = vmin(torch.maximum(dx, dy), 0.0) + torch.sqrt(
            torch.maximum(dx, zero) ** 2 + torch.maximum(dy, zero) ** 2
            + 1e-12)
        return 0.4 * (box2 - 0.05)

    return _posed("Trefoil", f, (5.0, 5.0, 1.5), conf, sp.trefoil_spec())


def _box_sphere(name, size, radius, mode, bounds, conf) -> Shape:
    half = np.asarray(size) / 2

    def f(x, y, z):
        box_sdf = pr.box_c(x, y, z, half)
        sph = pr.sphere_c(x, y, z, radius)
        return ops._smooth_pair(box_sdf, sph, 0.25, mode)

    return _posed(name, f, bounds, conf,
                  sp.box_sphere_spec(half, radius, 0.25, mode))


def smooth_difference(conf=None) -> Shape:
    return _box_sphere("SmoothDifference", (3.0, 3.0, 0.5), 1.0,
                       "difference", (1.75, 1.75, 1.0), conf)


def smooth_intersection(conf=None) -> Shape:
    return _box_sphere("SmoothIntersection", (3.0, 3.0, 0.5), 1.0,
                       "intersection", (1.25, 1.25, 0.5), conf)


def smooth_intersection_big(conf=None) -> Shape:
    return _box_sphere("SmoothIntersection_big", (9.0, 9.0, 1.5), 3.0,
                       "intersection", (3.25, 3.25, 1.0), conf)


def csg(conf=None) -> Shape:
    """(sphere(3) ∩ box(4.5)) − (cyl_x ∪ cyl_y ∪ cyl_z), cylinders r=1.5."""
    f = ops.intersection3(
        lambda x, y, z: pr.sphere_c(x, y, z, 3.0),
        lambda x, y, z: pr.box_c(x, y, z, (2.25, 2.25, 2.25)),
    )
    cz = lambda x, y, z: pr.cylinder_c(x, y, z, 1.5)
    cx = lambda x, y, z: pr.cylinder_c(y, z, x, 1.5)
    cy = lambda x, y, z: pr.cylinder_c(z, x, y, 1.5)
    final = ops.difference3(f, ops.union3(cx, cy, cz))
    return _posed("CSG", final, (2.25, 2.25, 2.25), conf,
                  sp.csg_spec(3.0, (2.25, 2.25, 2.25), 1.5))


def box(conf=None) -> Shape:
    bx = getattr(conf, "box_x", 1.0) if conf is not None else 1.0
    by = getattr(conf, "box_y", 1.0) if conf is not None else 1.0
    bz = getattr(conf, "box_z", 1.0) if conf is not None else 1.0
    # config values are half-extents (ref Shape.hpp:2344-2351)
    return _posed(
        "Box", lambda x, y, z: pr.box_c(x, y, z, (bx, by, bz)),
        (bx, by, bz), conf, sp.box_spec((bx, by, bz)),
    )


SHAPE_REGISTRY = {
    "Ball": ball,
    "Point": point,
    "Torus": torus,
    "Torus_big": torus_big,
    "Cappedtorus": capped_torus,
    "CappedCone": capped_cone,
    "RoundedCone": rounded_cone,
    "WireframeBox": wireframe_box,
    "BendLinear": bend_linear,
    "BendLinear_big": bend_linear_big,
    "TwistBox": twist_box,
    "BendBox": bend_box,
    "Table": table,
    "Blobby": blobby,
    "Trefoil": trefoil,
    "SmoothDifference": smooth_difference,
    "SmoothIntersection": smooth_intersection,
    "SmoothIntersection_big": smooth_intersection_big,
    "CSG": csg,
    "Box": box,
}


def make_shape(name: str, conf=None) -> Shape:
    """Shape factory (ref sw_manager.hpp:74-123 shapeConstructors)."""
    if name not in SHAPE_REGISTRY:
        raise KeyError(
            f"unknown shape {name!r}; known: {sorted(SHAPE_REGISTRY)}")
    return SHAPE_REGISTRY[name](conf)
