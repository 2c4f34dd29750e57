"""Analytic SDF primitives in component form (counterpart of
``isdf_tpu/shapes/primitives.py``).

Every primitive is ``f(px, py, pz, *params) → d`` over broadcasting tensors;
gradients come from autograd.  The ``_EPS`` guards and the ``where`` patterns
keep both branches finite so no NaN leaks into a gradient.  ``vmax``/``vmin``
/``clip``/``vabs`` carry JAX's gradient convention at ties
(core/smoothing.py).
"""

from __future__ import annotations

import math

import torch

from isdf_torch.core.smoothing import clip, vabs, vmax, vmin

_EPS = 1e-12


def _n3(x, y, z):
    """NaN-safe 3-component norm (gradient defined at 0)."""
    return torch.sqrt(x * x + y * y + z * z + _EPS)


def _n2(x, y):
    return torch.sqrt(x * x + y * y + _EPS)


def _where(c, a, b, like):
    """torch.where with Python-float arms, typed like ``like``."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return torch.where(c, a, b)


# -- quadrics ---------------------------------------------------------------

def sphere_c(px, py, pz, r):
    return _n3(px, py, pz) - r


def point_c(px, py, pz):
    return _n3(px, py, pz)


def box_c(px, py, pz, half):
    hx, hy, hz = (float(h) for h in half)
    qx = vabs(px) - hx
    qy = vabs(py) - hy
    qz = vabs(pz) - hz
    outside = _n3(vmax(qx, 0.0), vmax(qy, 0.0), vmax(qz, 0.0))
    inside = vmin(vmax(qx, vmax(qy, qz)), 0.0)
    return outside + inside


def rounded_box_c(px, py, pz, half, r):
    return box_c(px, py, pz, half) - r


def wireframe_box_c(px, py, pz, size, thickness):
    sx, sy, sz = (float(s) for s in size)
    th = float(thickness)
    psx = vabs(px) - sx / 2 - th / 2
    psy = vabs(py) - sy / 2 - th / 2
    psz = vabs(pz) - sz / 2 - th / 2
    qx = vabs(psx + th / 2) - th / 2
    qy = vabs(psy + th / 2) - th / 2
    qz = vabs(psz + th / 2) - th / 2

    def g(a, b, c):
        return _n3(vmax(a, 0.0), vmax(b, 0.0), vmax(c, 0.0)) + vmin(
            vmax(a, vmax(b, c)), 0.0)

    return vmin(vmin(g(psx, qy, qz), g(qx, psy, qz)), g(qx, qy, psz))


def torus_c(px, py, pz, ring_r, tube_r):
    """Torus in the x–z plane (axis = y)."""
    qx = _n2(px, pz) - ring_r
    return _n2(qx, py) - tube_r


def capped_torus_c(px, py, pz, sc, ra, rb):
    s0, s1 = float(sc[0]), float(sc[1])
    ax = vabs(px)
    k = torch.where(s1 * ax > s0 * py, ax * s0 + py * s1, _n2(ax, py))
    psq = ax * ax + py * py + pz * pz
    return torch.sqrt(vmax(psq + ra * ra - 2.0 * ra * k, _EPS)) - rb


def capsule_c(px, py, pz, a, b, r):
    ax, ay, az = (float(v) for v in a)
    bx, by, bz = (float(v) for v in b)
    pax, pay, paz = px - ax, py - ay, pz - az
    bax, bay, baz = bx - ax, by - ay, bz - az
    bb = bax * bax + bay * bay + baz * baz
    h = clip((pax * bax + pay * bay + paz * baz) / bb, 0.0, 1.0)
    return _n3(pax - h * bax, pay - h * bay, paz - h * baz) - r


def cylinder_c(px, py, pz, r):
    """Infinite cylinder along z."""
    return _n2(px, py) - r


def capped_cylinder_c(px, py, pz, r, h):
    dx = _n2(px, py) - r
    dy = vabs(pz) - h
    return vmin(vmax(dx, dy), 0.0) + _n2(vmax(dx, 0.0), vmax(dy, 0.0))


def rounded_cylinder_c(px, py, pz, ra, rb, h):
    dx = _n2(px, py) - 2.0 * ra + rb
    dy = vabs(pz) - h
    return (vmin(vmax(dx, dy), 0.0)
            + _n2(vmax(dx, 0.0), vmax(dy, 0.0)) - rb)


def capped_cone_c(px, py, pz, a, b, ra, rb):
    """Capped cone between a (radius ra) and b (radius rb), with the
    reference's s·sqrt(|d|)/|baba| metric (d already squared)."""
    ax, ay, az = (float(v) for v in a)
    bx, by, bz = (float(v) for v in b)
    rba = rb - ra
    bax, bay, baz = bx - ax, by - ay, bz - az
    baba = bax * bax + bay * bay + baz * baz
    pax, pay, paz = px - ax, py - ay, pz - az
    papa = pax * pax + pay * pay + paz * paz
    paba = (pax * bax + pay * bay + paz * baz) / baba
    x = torch.sqrt(vmax(papa - paba * paba * baba, _EPS))
    cax = vmax(x - _where(paba < 0.5, ra, rb, x), 0.0)
    cay = vabs(paba - 0.5) - 0.5
    k = rba * rba + baba
    f = clip((rba * (x - ra) + paba * baba) / k, 0.0, 1.0)
    cbx = x - ra - f * rba
    cby = paba - f
    s = _where((cbx < 0.0) & (cay < 0.0), -1.0, 1.0, x)
    d = torch.sqrt(
        vmin(cax * cax + cay * cay * baba, cbx * cbx + cby * cby * baba))
    return s * torch.sqrt(vmax(d, _EPS)) / baba


def rounded_cone_c(px, py, pz, r1, r2, h):
    """Round cone along +z from radius r1 at 0 to r2 at h."""
    qx = _n2(px, py)
    qy = pz
    b = (r1 - r2) / h
    a = math.sqrt(max(1.0 - b * b, _EPS))
    k = -b * qx + a * qy
    c1 = _n2(qx, qy) - r1
    c2 = torch.sqrt(qx * qx + (qy - h) ** 2 + _EPS) - r2
    c3 = (a * qx + b * qy) - r1
    return torch.where(k < 0.0, c1, torch.where(k > a * h, c2, c3))


def ellipsoid_c(px, py, pz, radii):
    rx, ry, rz = (float(r) for r in radii)
    k0 = _n3(px / rx, py / ry, pz / rz)
    k1 = _n3(px / (rx * rx), py / (ry * ry), pz / (rz * rz))
    return k0 * (k0 - 1.0) / vmax(k1, _EPS)


def plane_c(px, py, pz, n, d=0.0):
    nx, ny, nz = (float(v) for v in n)
    return px * nx + py * ny + pz * nz + d


def octahedron_c(px, py, pz, s):
    return (vabs(px) + vabs(py) + vabs(pz) - s) * 0.57735027


def pyramid_c(px, py, pz, h):
    """Square pyramid, base side 1 on the y=0 plane, apex height h."""
    m2 = h * h + 0.25
    apx = vabs(px)
    apz = vabs(pz)
    swap = apz > apx
    px2 = torch.where(swap, apz, apx) - 0.5
    pz2 = torch.where(swap, apx, apz) - 0.5
    qx = pz2
    qy = h * py - 0.5 * px2
    qz = h * px2 + 0.5 * py
    s = vmax(-qx, 0.0)
    t = clip((qy - 0.5 * pz2) / (m2 + 0.25), 0.0, 1.0)
    a = m2 * (qx + s) ** 2 + qy * qy
    b = m2 * (qx + 0.5 * t) ** 2 + (qy - m2 * t) ** 2
    d2 = _where(vmin(qy, -qx * m2 - qy * 0.5) > 0.0, 0.0, vmin(a, b), a)
    return torch.sqrt(vmax((d2 + qz * qz) / m2, _EPS)) * torch.sign(
        vmax(qz, -py))


def tetrahedron_c(px, py, pz, r):
    md = vmax(vmax(-px - py - pz, px + py - pz),
              vmax(-px + py + pz, px - py + pz))
    return (md - r) / math.sqrt(3.0)


_PHI = (1 + math.sqrt(5.0)) / 2


def dodecahedron_c(px, py, pz, r):
    n0 = _PHI / math.sqrt(_PHI * _PHI + 1.0)
    n1 = 1.0 / math.sqrt(_PHI * _PHI + 1.0)
    qx, qy, qz = vabs(px), vabs(py), vabs(pz)
    d = vmax(vmax(qx * n0 + qy * n1, qy * n0 + qz * n1), qz * n0 + qx * n1)
    return d - r * n0


def icosahedron_c(px, py, pz, r):
    n1 = 1.0 / math.sqrt(3.0)
    nn = math.sqrt((_PHI + 1.0) ** 2 + 1.0)
    n20, n21 = (_PHI + 1.0) / nn, 1.0 / nn
    qx, qy, qz = vabs(px), vabs(py), vabs(pz)
    a = (qx + qy + qz) * n1
    b = vmax(vmax(qx * n20 + qy * n21, qy * n20 + qz * n21),
             qz * n20 + qx * n21)
    return vmax(a, b) - r * n1


# -- the classic (..., 3) API: one slice of the point axis at the root ------

def _aos(f3):
    """Component-form primitive → ``f(p (..., 3), *params) → d (...)``."""
    def f(p, *args, **kw):
        return f3(p[..., 0], p[..., 1], p[..., 2], *args, **kw)
    return f


sphere = _aos(sphere_c)
point = _aos(point_c)
box = _aos(box_c)
rounded_box = _aos(rounded_box_c)
wireframe_box = _aos(wireframe_box_c)
torus = _aos(torus_c)
capped_torus = _aos(capped_torus_c)
capsule = _aos(capsule_c)
cylinder = _aos(cylinder_c)
capped_cylinder = _aos(capped_cylinder_c)
rounded_cylinder = _aos(rounded_cylinder_c)
capped_cone = _aos(capped_cone_c)
rounded_cone = _aos(rounded_cone_c)
ellipsoid = _aos(ellipsoid_c)
plane = _aos(plane_c)
octahedron = _aos(octahedron_c)
pyramid = _aos(pyramid_c)
tetrahedron = _aos(tetrahedron_c)
dodecahedron = _aos(dodecahedron_c)
icosahedron = _aos(icosahedron_c)
