"""Device descriptions of zoo shapes for the CUDA sweep kernels.

On the TPU the shape's Python closure is traced into the Pallas kernel; a
CUDA kernel cannot take a closure.  A ``ShapeSpec`` names one of the SDFs
written as templated ``__device__`` functions in ``csrc/sweep_warm.cu`` and
carries its constants (derived on the host in double precision, as the
closures derive theirs from Python floats) and the ``poly_params`` pose.
Shapes that differ only in constants share a kind.

``spec_sdf3`` is the plain PyTorch form of those device functions, written
from the same constants in the same order of operations, so the tests can
hold each spec against the zoo closure it describes and the device code can
be read against it line by line.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from isdf_torch.core.smoothing import clip, sqrt0, vabs, vmax, vmin

EPS = 1e-12
MAX_PARAMS = 24

# kind ids; the same numbers are the ``SDF_*`` constants of sweep_warm.cu
BALL = 1
ROUNDED_CONE = 2
CAPPED_CONE = 3
TORUS = 4
CAPPED_TORUS = 5
WIREFRAME_BOX = 6
BEND_LINEAR = 7
TWIST_BOX = 8
BEND_BOX = 9
TABLE = 10
BLOBBY = 11
TREFOIL = 12
BOX_SPHERE = 13
CSG = 14
BOX = 15
POINT = 16
KINDS = tuple(range(BALL, POINT + 1))

# BOX_SPHERE's smooth boolean, carried as its last constant
MODES = {"intersection": 0.0, "difference": 1.0}


@dataclass(frozen=True)
class ShapeSpec:
    kind: int
    params: Tuple[float, ...]
    R: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    t: Tuple[float, ...] = (0.0, 0.0, 0.0)
    posed: bool = False

    def __post_init__(self):
        if len(self.params) > MAX_PARAMS:
            raise ValueError(f"{len(self.params)} constants, the device "
                             f"struct holds {MAX_PARAMS}")

    def with_pose(self, R, t) -> "ShapeSpec":
        return ShapeSpec(self.kind, self.params,
                         tuple(float(v) for v in np.asarray(R).ravel()),
                         tuple(float(v) for v in np.asarray(t).ravel()),
                         True)


def _f(vals) -> Tuple[float, ...]:
    return tuple(float(v) for v in vals)


def ball_spec(radius: float) -> ShapeSpec:
    return ShapeSpec(BALL, (float(radius),))


def rounded_cone_spec(r1: float, r2: float, h: float) -> ShapeSpec:
    b = (r1 - r2) / h
    a = math.sqrt(max(1.0 - b * b, EPS))
    return ShapeSpec(ROUNDED_CONE, (r1, r2, h, b, a, a * h))


def capped_cone_spec(a, b, ra: float, rb: float) -> ShapeSpec:
    ax, ay, az = _f(a)
    bx, by, bz = _f(b)
    rba = rb - ra
    bax, bay, baz = bx - ax, by - ay, bz - az
    baba = bax * bax + bay * bay + baz * baz
    k = rba * rba + baba
    return ShapeSpec(CAPPED_CONE,
                     (ax, ay, az, bax, bay, baz, baba, ra, rb, rba, k))


def torus_spec(ring_r: float, tube_r: float) -> ShapeSpec:
    return ShapeSpec(TORUS, _f((ring_r, tube_r)))


def capped_torus_spec(sc, ra: float, rb: float) -> ShapeSpec:
    return ShapeSpec(CAPPED_TORUS,
                     _f((sc[0], sc[1], ra * ra, 2.0 * ra, rb)))


def wireframe_box_spec(size, thickness: float) -> ShapeSpec:
    sx, sy, sz = _f(size)
    return ShapeSpec(WIREFRAME_BOX,
                     (sx / 2, sy / 2, sz / 2, float(thickness) / 2))


def bend_linear_spec(p0, p1, v, cap_a, cap_b, cap_r: float) -> ShapeSpec:
    """Linear bend (ease = in-out quad) of a capsule cap_a → cap_b."""
    p0 = np.asarray(p0, dtype=np.float64)
    ab = np.asarray(p1, dtype=np.float64) - p0
    a = np.asarray(cap_a, dtype=np.float64)
    ba = np.asarray(cap_b, dtype=np.float64) - a
    return ShapeSpec(BEND_LINEAR, _f((
        *p0, *ab, ab @ ab, *np.asarray(v, dtype=np.float64),
        *a, *ba, ba @ ba, cap_r)))


def twist_box_spec(k: float, half) -> ShapeSpec:
    return ShapeSpec(TWIST_BOX, _f((k, *half)))


def bend_box_spec(k: float, half) -> ShapeSpec:
    return ShapeSpec(BEND_BOX, _f((k, *half)))


def table_spec(c1, h1, c2, h2) -> ShapeSpec:
    return ShapeSpec(TABLE, _f((*c1, *h1, *c2, *h2)))


def blobby_spec(balls, k: float) -> ShapeSpec:
    """Smooth union ((b0 ∪ b1) ∪ (b2 ∪ b3)) of four balls (cx, cy, cz, r)."""
    if len(balls) != 4:
        raise ValueError("Blobby is four balls")
    return ShapeSpec(BLOBBY, _f((*(v for b in balls for v in b), k)))


def trefoil_spec() -> ShapeSpec:
    return ShapeSpec(TREFOIL, ())


def box_sphere_spec(half, radius: float, k: float, mode: str) -> ShapeSpec:
    return ShapeSpec(BOX_SPHERE, _f((*half, radius, k, MODES[mode])))


def csg_spec(sphere_r: float, half, cyl_r: float) -> ShapeSpec:
    return ShapeSpec(CSG, _f((sphere_r, *half, cyl_r)))


def box_spec(half) -> ShapeSpec:
    return ShapeSpec(BOX, _f(half))


def point_spec() -> ShapeSpec:
    return ShapeSpec(POINT, ())


# ---------------------------------------------------------------------------
# plain forms, one per kind, in the device functions' order of operations

def _n3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z + EPS)


def _n2(x, y):
    return torch.sqrt(x * x + y * y + EPS)


def _box(x, y, z, hx, hy, hz):
    qx, qy, qz = vabs(x) - hx, vabs(y) - hy, vabs(z) - hz
    outside = _n3(vmax(qx, 0.0), vmax(qy, 0.0), vmax(qz, 0.0))
    inside = vmin(vmax(qx, vmax(qy, qz)), 0.0)
    return outside + inside


def _smooth_union(d1, d2, k):
    h = clip(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
    m = d2 + (d1 - d2) * h
    return m - k * h * (1.0 - h)


def _ball(p, x, y, z):
    return torch.sqrt(x * x + y * y + z * z + EPS) - p[0]


def _rounded_cone(p, x, y, z):
    r1, r2, h, b, a, ah = p
    qx = torch.sqrt(x * x + y * y + EPS)
    qy = z
    k = -b * qx + a * qy
    c1 = torch.sqrt(qx * qx + qy * qy + EPS) - r1
    qh = qy - h
    c2 = torch.sqrt(qx * qx + qh * qh + EPS) - r2
    c3 = (a * qx + b * qy) - r1
    return torch.where(k < 0.0, c1, torch.where(k > ah, c2, c3))


def _capped_cone(p, x, y, z):
    ax, ay, az, bax, bay, baz, baba, ra, rb, rba, kk = p
    pax, pay, paz = x - ax, y - ay, z - az
    papa = pax * pax + pay * pay + paz * paz
    paba = (pax * bax + pay * bay + paz * baz) / baba
    xx = torch.sqrt(vmax(papa - paba * paba * baba, EPS))
    rr = torch.where(paba < 0.5, torch.full_like(xx, ra),
                     torch.full_like(xx, rb))
    cax = vmax(xx - rr, 0.0)
    cay = vabs(paba - 0.5) - 0.5
    f = clip((rba * (xx - ra) + paba * baba) / kk, 0.0, 1.0)
    cbx = xx - ra - f * rba
    cby = paba - f
    s = torch.where((cbx < 0.0) & (cay < 0.0), torch.full_like(xx, -1.0),
                    torch.full_like(xx, 1.0))
    d = sqrt0(
        vmin(cax * cax + cay * cay * baba, cbx * cbx + cby * cby * baba))
    return s * torch.sqrt(vmax(d, EPS)) / baba


def _torus(p, x, y, z):
    ring_r, tube_r = p
    return _n2(_n2(x, z) - ring_r, y) - tube_r


def _capped_torus(p, x, y, z):
    s0, s1, ra2, two_ra, rb = p
    ax = vabs(x)
    k = torch.where(s1 * ax > s0 * y, ax * s0 + y * s1, _n2(ax, y))
    psq = ax * ax + y * y + z * z
    return torch.sqrt(vmax(psq + ra2 - two_ra * k, EPS)) - rb


def _wireframe_box(p, x, y, z):
    hx, hy, hz, ht = p
    psx, psy, psz = vabs(x) - hx - ht, vabs(y) - hy - ht, vabs(z) - hz - ht
    qx, qy, qz = vabs(psx + ht) - ht, vabs(psy + ht) - ht, vabs(psz + ht) - ht

    def g(a, b, c):
        return _n3(vmax(a, 0.0), vmax(b, 0.0), vmax(c, 0.0)) + vmin(
            vmax(a, vmax(b, c)), 0.0)

    return vmin(vmin(g(psx, qy, qz), g(qx, psy, qz)), g(qx, qy, psz))


def _bend_linear(p, x, y, z):
    (p0x, p0y, p0z, abx, aby, abz, ab2, vx, vy, vz,
     ax, ay, az, bax, bay, baz, bb, r) = p
    t = clip(((x - p0x) * abx + (y - p0y) * aby + (z - p0z) * abz) / ab2,
             0.0, 1.0)
    u = 2 * t - 1
    e = torch.where(t < 0.5, 2 * t * t, -0.5 * (u * (u - 2) - 1))
    pax, pay, paz = e * vx + x - ax, e * vy + y - ay, e * vz + z - az
    h = clip((pax * bax + pay * bay + paz * baz) / bb, 0.0, 1.0)
    return _n3(pax - h * bax, pay - h * bay, paz - h * baz) - r


def _twist_box(p, x, y, z):
    k, hx, hy, hz = p
    c, s = torch.cos(k * z), torch.sin(k * z)
    return _box(c * x - s * y, s * x + c * y, z, hx, hy, hz)


def _bend_box(p, x, y, z):
    k, hx, hy, hz = p
    c, s = torch.cos(k * x), torch.sin(k * x)
    return _box(c * x - s * y, s * x + c * y, z, hx, hy, hz)


def _table(p, x, y, z):
    qx, qy = vabs(x), vabs(y)
    f1 = _box(qx - p[0], qy - p[1], z - p[2], *p[3:6])
    f2 = _box(qx - p[6], qy - p[7], z - p[8], *p[9:12])
    return vmin(f1, f2)


def _blobby(p, x, y, z):
    s = [_n3(x - p[4 * i], y - p[4 * i + 1], z - p[4 * i + 2]) - p[4 * i + 3]
         for i in range(4)]
    k = p[16]
    return _smooth_union(_smooth_union(s[0], s[1], k),
                         _smooth_union(s[2], s[3], k), k)


def _trefoil(p, x, y, z):
    a = torch.atan2(y, x)
    qx = torch.sqrt(x * x + y * y + EPS) - 3.5
    qy = -z
    c, s = torch.cos(1.5 * a), torch.sin(1.5 * a)
    qx, qy = qx * c + qy * s, qy * c - qx * s
    fold = -math.pi * torch.floor(torch.atan2(qy, qx) / math.pi + 0.5)
    c, s = torch.cos(fold), torch.sin(fold)
    qx, qy = qx * c + qy * s, qy * c - qx * s
    qx = qx - 1.0
    dx, dy = vabs(qx) - 0.2, vabs(qy) - 0.2
    mx, my = vmax(dx, 0.0), vmax(dy, 0.0)
    box2 = vmin(vmax(dx, dy), 0.0) + torch.sqrt(mx * mx + my * my + EPS)
    return 0.4 * (box2 - 0.05)


def _box_sphere(p, x, y, z):
    hx, hy, hz, radius, k, mode = p
    d1 = _box(x, y, z, hx, hy, hz)
    d2 = _n3(x, y, z) - radius
    if mode == MODES["intersection"]:
        h = clip(0.5 - 0.5 * (d2 - d1) / k, 0.0, 1.0)
        m = d2 + (d1 - d2) * h
    else:
        h = clip(0.5 - 0.5 * (d2 + d1) / k, 0.0, 1.0)
        m = d1 - (d1 + d2) * h
    return m + k * h * (1.0 - h)


def _csg(p, x, y, z):
    rs, hx, hy, hz, rc = p
    f = vmax(_n3(x, y, z) - rs, _box(x, y, z, hx, hy, hz))
    g = vmin(vmin(_n2(y, z) - rc, _n2(z, x) - rc), _n2(x, y) - rc)
    return vmax(f, -g)


def _box_body(p, x, y, z):
    return _box(x, y, z, *p)


def _point(p, x, y, z):
    return _n3(x, y, z)


_BODY = {
    BALL: _ball, ROUNDED_CONE: _rounded_cone, CAPPED_CONE: _capped_cone,
    TORUS: _torus, CAPPED_TORUS: _capped_torus,
    WIREFRAME_BOX: _wireframe_box, BEND_LINEAR: _bend_linear,
    TWIST_BOX: _twist_box, BEND_BOX: _bend_box, TABLE: _table,
    BLOBBY: _blobby, TREFOIL: _trefoil, BOX_SPHERE: _box_sphere, CSG: _csg,
    BOX: _box_body, POINT: _point,
}


def spec_sdf3(spec: ShapeSpec, x, y, z):
    """Plain evaluation of the device SDF that ``spec`` describes."""
    if spec.posed:
        R, (tx, ty, tz) = spec.R, spec.t
        dx, dy, dz = x - tx, y - ty, z - tz
        x, y, z = (R[0] * dx + R[3] * dy + R[6] * dz,
                   R[1] * dx + R[4] * dy + R[7] * dz,
                   R[2] * dx + R[5] * dy + R[8] * dz)
    return _BODY[spec.kind](spec.params, x, y, z)
