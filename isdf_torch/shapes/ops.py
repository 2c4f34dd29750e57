"""CSG combinators over SDF functions (counterpart of
``isdf_tpu/shapes/ops.py``).

An "SDF3" is a callable ``(px, py, pz) → d`` over broadcasting tensors;
the ``*3`` combinators return new callables.  ``aos`` derives the classic
``p (..., 3) → d`` form ("SDF") by slicing once at the root; the
combinators without the suffix take and return that form, each the
component-form combinator between ``_c`` and ``aos``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from isdf_torch.core.smoothing import clip, vabs, vmax, vmin

SDF3 = Callable[..., torch.Tensor]
SDF = Callable[[torch.Tensor], torch.Tensor]


def _smooth_pair(d1, d2, k, mode: str):
    """Polynomial smooth boolean blend (the reference's h/m formulation)."""
    if mode == "union":
        h = clip(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
        m = d2 + (d1 - d2) * h
        return m - k * h * (1.0 - h)
    if mode == "intersection":
        h = clip(0.5 - 0.5 * (d2 - d1) / k, 0.0, 1.0)
        m = d2 + (d1 - d2) * h
        return m + k * h * (1.0 - h)
    if mode == "difference":
        h = clip(0.5 - 0.5 * (d2 + d1) / k, 0.0, 1.0)
        m = d1 - (d1 + d2) * h
        return m + k * h * (1.0 - h)
    raise ValueError(mode)


def translate3(f: SDF3, offset) -> SDF3:
    ox, oy, oz = (float(v) for v in offset)
    return lambda x, y, z: f(x - ox, y - oy, z - oz)


def scale3(f: SDF3, factor: float) -> SDF3:
    k = float(factor)
    return lambda x, y, z: f(x / k, y / k, z / k) * k


def rotate3(f: SDF3, R) -> SDF3:
    """Rotate the *shape* by R (query is pulled back by Rᵀ)."""
    R = np.asarray(R, dtype=np.float64).tolist()
    return lambda x, y, z: f(
        R[0][0] * x + R[1][0] * y + R[2][0] * z,
        R[0][1] * x + R[1][1] * y + R[2][1] * z,
        R[0][2] * x + R[1][2] * y + R[2][2] * z,
    )


def transformed3(f: SDF3, R, t) -> SDF3:
    """Shape posed at rotation R, translation t."""
    R = np.asarray(R, dtype=np.float64).tolist()
    tx, ty, tz = (float(v) for v in np.asarray(t))
    return lambda x, y, z: f(
        R[0][0] * (x - tx) + R[1][0] * (y - ty) + R[2][0] * (z - tz),
        R[0][1] * (x - tx) + R[1][1] * (y - ty) + R[2][1] * (z - tz),
        R[0][2] * (x - tx) + R[1][2] * (y - ty) + R[2][2] * (z - tz),
    )


def union3(*fs: SDF3) -> SDF3:
    def g(x, y, z):
        d = fs[0](x, y, z)
        for f in fs[1:]:
            d = vmin(d, f(x, y, z))
        return d

    return g


def intersection3(*fs: SDF3) -> SDF3:
    def g(x, y, z):
        d = fs[0](x, y, z)
        for f in fs[1:]:
            d = vmax(d, f(x, y, z))
        return d

    return g


def difference3(f: SDF3, g: SDF3) -> SDF3:
    return lambda x, y, z: vmax(f(x, y, z), -g(x, y, z))


def smooth_union3(f: SDF3, g: SDF3, k: float = 0.25) -> SDF3:
    return lambda x, y, z: _smooth_pair(f(x, y, z), g(x, y, z), k, "union")


def smooth_intersection3(f: SDF3, g: SDF3, k: float = 0.25) -> SDF3:
    return lambda x, y, z: _smooth_pair(
        f(x, y, z), g(x, y, z), k, "intersection")


def smooth_difference3(f: SDF3, g: SDF3, k: float = 0.25) -> SDF3:
    return lambda x, y, z: _smooth_pair(
        f(x, y, z), g(x, y, z), k, "difference")


def blend3(f: SDF3, g: SDF3, t: float = 0.5) -> SDF3:
    return lambda x, y, z: (1.0 - t) * f(x, y, z) + t * g(x, y, z)


def negate3(f: SDF3) -> SDF3:
    return lambda x, y, z: -f(x, y, z)


def dilate3(f: SDF3, r: float) -> SDF3:
    return lambda x, y, z: f(x, y, z) - r


def erode3(f: SDF3, r: float) -> SDF3:
    return lambda x, y, z: f(x, y, z) + r


def shell3(f: SDF3, thickness: float) -> SDF3:
    return lambda x, y, z: vabs(f(x, y, z)) - thickness


def twist3(f: SDF3, k: float) -> SDF3:
    """Twist about z: rotate the xy slice by k·z."""

    def g(x, y, z):
        c, s = torch.cos(k * z), torch.sin(k * z)
        return f(c * x - s * y, s * x + c * y, z)

    return g


def bend3(f: SDF3, k: float) -> SDF3:
    """Bend: rotate the xy slice by k·x."""

    def g(x, y, z):
        c, s = torch.cos(k * x), torch.sin(k * x)
        return f(c * x - s * y, s * x + c * y, z)

    return g


def _in_out_quad(t):
    u = 2 * t - 1
    return torch.where(t < 0.5, 2 * t * t, -0.5 * (u * (u - 2) - 1))


def bend_linear3(f: SDF3, p0, p1, v, ease=None) -> SDF3:
    """Linear bend: query f(ease(t)·v + p), t the p0→p1 parameter."""
    p0n = np.asarray(p0, dtype=np.float64)
    abn = np.asarray(p1, dtype=np.float64) - p0n
    vx, vy, vz = (float(c) for c in np.asarray(v))
    ab2 = float(abn @ abn)
    p0, ab = p0n.tolist(), abn.tolist()
    ease = _in_out_quad if ease is None else ease

    def g(x, y, z):
        t = clip(
            ((x - p0[0]) * ab[0] + (y - p0[1]) * ab[1] + (z - p0[2]) * ab[2])
            / ab2,
            0.0,
            1.0,
        )
        e = ease(t)
        return f(e * vx + x, e * vy + y, e * vz + z)

    return g


def aos(f3: SDF3) -> SDF:
    """Component-form SDF → classic (..., 3) API (one slice at the root)."""
    return lambda p: f3(p[..., 0], p[..., 1], p[..., 2])


def _c(f: SDF) -> SDF3:
    """Classic (..., 3) SDF → component form (one stack at the leaf)."""
    return lambda x, y, z: f(torch.stack(torch.broadcast_tensors(x, y, z),
                                         dim=-1))


# -- the classic (..., 3) API ----------------------------------------------

def translate(f: SDF, offset) -> SDF:
    return aos(translate3(_c(f), offset))


def scale(f: SDF, factor: float) -> SDF:
    return aos(scale3(_c(f), factor))


def rotate(f: SDF, R) -> SDF:
    """Rotate the *shape* by R (query is pulled back by Rᵀ)."""
    return aos(rotate3(_c(f), R))


def transformed(f: SDF, R, t) -> SDF:
    """Shape posed at rotation R, translation t."""
    return aos(transformed3(_c(f), R, t))


def union(*fs: SDF) -> SDF:
    return aos(union3(*map(_c, fs)))


def intersection(*fs: SDF) -> SDF:
    return aos(intersection3(*map(_c, fs)))


def difference(f: SDF, g: SDF) -> SDF:
    return aos(difference3(_c(f), _c(g)))


def smooth_union(f: SDF, g: SDF, k: float = 0.25) -> SDF:
    return aos(smooth_union3(_c(f), _c(g), k))


def smooth_intersection(f: SDF, g: SDF, k: float = 0.25) -> SDF:
    return aos(smooth_intersection3(_c(f), _c(g), k))


def smooth_difference(f: SDF, g: SDF, k: float = 0.25) -> SDF:
    return aos(smooth_difference3(_c(f), _c(g), k))


def blend(f: SDF, g: SDF, t: float = 0.5) -> SDF:
    return aos(blend3(_c(f), _c(g), t))


def negate(f: SDF) -> SDF:
    return aos(negate3(_c(f)))


def dilate(f: SDF, r: float) -> SDF:
    return aos(dilate3(_c(f), r))


def erode(f: SDF, r: float) -> SDF:
    return aos(erode3(_c(f), r))


def shell(f: SDF, thickness: float) -> SDF:
    return aos(shell3(_c(f), thickness))


def twist(f: SDF, k: float) -> SDF:
    """Twist about z: rotate the xy slice by k·z."""
    return aos(twist3(_c(f), k))


def bend(f: SDF, k: float) -> SDF:
    """Bend: rotate the xy slice by k·x."""
    return aos(bend3(_c(f), k))


def bend_linear(f: SDF, p0, p1, v, ease=None) -> SDF:
    """Linear bend: query f(ease(t)·v + p), t the p0→p1 parameter."""
    return aos(bend_linear3(_c(f), p0, p1, v, ease))
