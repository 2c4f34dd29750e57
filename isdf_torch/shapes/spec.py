"""Device descriptions of zoo shapes for the CUDA sweep kernel.

On the TPU the shape's Python closure is traced into the Pallas kernel; a
CUDA kernel cannot take a closure.  A ``ShapeSpec`` names one of the SDFs
written as templated ``__device__`` functions in ``csrc/sweep_warm.cu`` and
carries its constants (derived on the host in double precision, as the
closures derive theirs from Python floats) and the ``poly_params`` pose.

``spec_sdf3`` is the plain PyTorch form of those device functions, so the
tests can hold each spec against the zoo closure it describes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from isdf_torch.core.smoothing import clip, vabs, vmax, vmin

EPS = 1e-12
MAX_PARAMS = 16

# kind ids; the same numbers are the ``SDF_*`` constants of sweep_warm.cu
BALL = 1
ROUNDED_CONE = 2
CAPPED_CONE = 3


@dataclass(frozen=True)
class ShapeSpec:
    kind: int
    params: Tuple[float, ...]
    R: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    t: Tuple[float, ...] = (0.0, 0.0, 0.0)
    posed: bool = False

    def with_pose(self, R, t) -> "ShapeSpec":
        return ShapeSpec(self.kind, self.params,
                         tuple(float(v) for v in np.asarray(R).ravel()),
                         tuple(float(v) for v in np.asarray(t).ravel()),
                         True)


def ball_spec(radius: float) -> ShapeSpec:
    return ShapeSpec(BALL, (float(radius),))


def rounded_cone_spec(r1: float, r2: float, h: float) -> ShapeSpec:
    b = (r1 - r2) / h
    a = math.sqrt(max(1.0 - b * b, EPS))
    return ShapeSpec(ROUNDED_CONE, (r1, r2, h, b, a, a * h))


def capped_cone_spec(a, b, ra: float, rb: float) -> ShapeSpec:
    ax, ay, az = (float(v) for v in a)
    bx, by, bz = (float(v) for v in b)
    rba = rb - ra
    bax, bay, baz = bx - ax, by - ay, bz - az
    baba = bax * bax + bay * bay + baz * baz
    k = rba * rba + baba
    return ShapeSpec(CAPPED_CONE,
                     (ax, ay, az, bax, bay, baz, baba, ra, rb, rba, k))


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
    d = torch.sqrt(
        vmin(cax * cax + cay * cay * baba, cbx * cbx + cby * cby * baba))
    return s * torch.sqrt(vmax(d, EPS)) / baba


_BODY = {BALL: _ball, ROUNDED_CONE: _rounded_cone, CAPPED_CONE: _capped_cone}


def spec_sdf3(spec: ShapeSpec, x, y, z):
    """Plain evaluation of the device SDF that ``spec`` describes."""
    if spec.posed:
        R, (tx, ty, tz) = spec.R, spec.t
        dx, dy, dz = x - tx, y - ty, z - tz
        x, y, z = (R[0] * dx + R[3] * dy + R[6] * dz,
                   R[1] * dx + R[4] * dy + R[7] * dz,
                   R[2] * dx + R[5] * dy + R[8] * dz)
    return _BODY[spec.kind](spec.params, x, y, z)
