"""Body SDFs in the body frame, by the name a configuration gives its body,
each from its geometric definition in plain PyTorch.  ``make(body, settings,
dtype, device)`` -> f(p (..., 3)) -> (...)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.frozen.shapes import l_prism


def pose(poly_params):
    """(R, t) of a config's pose (tx, ty, tz, roll, pitch, yaw in degrees),
    R = Rz Ry Rx."""
    tx, ty, tz, r, p, y = (list(poly_params) + [0.0] * 6)[:6]
    r, p, y = (math.radians(a) for a in (r, p, y))
    Rx = np.array([[1, 0, 0], [0, math.cos(r), -math.sin(r)],
                   [0, math.sin(r), math.cos(r)]])
    Ry = np.array([[math.cos(p), 0, math.sin(p)], [0, 1, 0],
                   [-math.sin(p), 0, math.cos(p)]])
    Rz = np.array([[math.cos(y), -math.sin(y), 0],
                   [math.sin(y), math.cos(y), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx, np.array([tx, ty, tz], dtype=np.float64)


def sqrt0(x):
    """sqrt(x) for x >= 0, with slope 0 where x = 0 (torch.sqrt's is
    infinite there, and its gradient NaN)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def rounded_cone(r1, r2, h):
    """A cone of radius r1 at z = 0 and r2 at z = h, rounded by spheres."""
    b = (r1 - r2) / h
    a = math.sqrt(1.0 - b * b)

    def f(p):
        qx = sqrt0(p[..., 0] ** 2 + p[..., 1] ** 2)
        qy = p[..., 2]
        k = -b * qx + a * qy
        bottom = torch.sqrt(qx * qx + qy * qy) - r1
        top = torch.sqrt(qx * qx + (qy - h) ** 2) - r2
        side = a * qx + b * qy - r1
        return torch.where(k < 0.0, bottom, torch.where(k > a * h, top, side))
    return f


def polygon_prism(ring, thick):
    """The exact SDF of a simple polygon (ring (n, 2), either orientation)
    extruded by ``thick`` about z = 0."""
    ring = np.asarray(ring, dtype=np.float64)

    def f(p):
        x, y = p[..., 0], p[..., 1]
        d2 = torch.full_like(x, float("inf"))
        inside = torch.zeros_like(x, dtype=torch.bool)
        n = len(ring)
        for i in range(n):
            ax, ay = ring[i]
            bx, by = ring[(i + 1) % n]
            ex, ey = bx - ax, by - ay
            wx, wy = x - ax, y - ay
            u = torch.clamp((wx * ex + wy * ey) / (ex * ex + ey * ey), 0, 1)
            d2 = torch.minimum(d2, (wx - u * ex) ** 2 + (wy - u * ey) ** 2)
            crosses = (ay > y) != (by > y)
            xi = ax + (y - ay) * ex / (ey if ey != 0 else 1.0)
            inside = inside ^ (crosses & (x < xi))
        d = torch.where(inside, -1.0, 1.0) * torch.sqrt(d2)
        wz = torch.abs(p[..., 2]) - 0.5 * thick
        out = torch.sqrt(torch.clamp(d, min=0) ** 2
                         + torch.clamp(wz, min=0) ** 2)
        return torch.clamp(torch.maximum(d, wz), max=0) + out
    return f


def baked(f, lo, n, res, dtype, device):
    """The body as the upstream planner holds a mesh robot: its SDF sampled
    at the nodes lo + i res of an (n) grid, interpolated trilinearly, and
    outside the grid the clamped value plus the distance to the grid's
    box."""
    axes = [torch.as_tensor(lo[i] + np.arange(n[i]) * res, dtype=torch.float64)
            for i in range(3)]
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    field = f(g).to(dtype=dtype, device=device)
    o = torch.as_tensor(lo, dtype=dtype, device=device)
    top = torch.as_tensor(np.asarray(n) - 1, dtype=dtype, device=device)

    def sdf(p):
        g = (p - o) / res
        gc = torch.minimum(torch.clamp(g, min=0.0), top)
        i0 = torch.minimum(torch.floor(gc), top - 1).long()
        fr = gc - i0.to(dtype)
        val = torch.zeros(p.shape[:-1], dtype=dtype, device=device)
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    wgt = ((fr[..., 0] if cx else 1 - fr[..., 0])
                           * (fr[..., 1] if cy else 1 - fr[..., 1])
                           * (fr[..., 2] if cz else 1 - fr[..., 2]))
                    val = val + wgt * field[i0[..., 0] + cx, i0[..., 1] + cy,
                                            i0[..., 2] + cz]
        over = torch.clamp(g - top, min=0.0) + torch.clamp(g, max=0.0)
        return val + res * sqrt0((over * over).sum(-1))
    return sdf


def make(body: dict, settings: dict, dtype, device):
    """The posed body SDF f(p_body) of a configuration."""
    R, t = pose(settings.get("poly_params", (0.0,) * 6))
    kind = body["reference"]
    if kind == "rounded_cone":
        f0 = rounded_cone(body["r1"], body["r2"], body["h"])
    elif kind == "l_prism":
        V, _ = l_prism(body["arm_x"], body["arm_y"], body["thick"])
        exact = polygon_prism(V[:6, :2], body["thick"])
        # the grid over the body's box and a margin, as the bake lays it
        lo = V.min(axis=0) - body["bake_margin"]
        hi = V.max(axis=0) + body["bake_margin"]
        res = settings["selfmapresu"]
        n = np.ceil((hi - lo) / res).astype(int) + 1
        f0 = baked(exact, lo, n, res, dtype, device)
    else:
        raise KeyError(f"no reference body {kind!r}")
    Rt = torch.as_tensor(R, dtype=dtype, device=device)
    tt = torch.as_tensor(t, dtype=dtype, device=device)
    if np.allclose(R, np.eye(3)) and np.allclose(t, 0.0):
        return f0
    return lambda p: f0((p - tt) @ Rt)
