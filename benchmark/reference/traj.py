"""Minimum-jerk piecewise quintics (MINCO, s = 3), their evaluation, the
quadrotor's tilt under drag, and the back end's cost, written from the
definitions in plain PyTorch.  Every function takes a leading batch axis.

A trajectory is (c (..., N, 6, 3), T (..., N)): piece i is
p(s) = sum_k c[i, k] s^k for s in [0, T_i].
"""

from __future__ import annotations

import math

import torch

NC = 6                     # coefficients of a quintic


def minco(q, T, head, tail):
    """The minimum-jerk trajectory through the interior waypoints q (...,
    N-1, 3) with durations T (..., N), from the head state to the tail
    state (..., 3, 3; columns position, velocity, acceleration) -> c.

    Unknowns c (6N, 3).  Rows: the head's three derivatives; at each
    junction the waypoint and the continuity of derivatives 0..4; the
    tail's three derivatives.  bfloat16 has no solver: its system is
    solved in float32."""
    dt = T.dtype
    sol_dt = torch.float32 if dt == torch.bfloat16 else dt
    Tw = T.to(sol_dt)
    lead = Tw.shape[:-1]
    N = Tw.shape[-1]
    n = NC * N
    A = torch.zeros(lead + (n, n), dtype=sol_dt, device=T.device)
    b = torch.zeros(lead + (n, 3), dtype=sol_dt, device=T.device)

    def row_at(t, d):
        # d-th derivative of the monomials 1, s, ..., s^5 at s = t
        cols = []
        for k in range(NC):
            if k < d:
                cols.append(torch.zeros_like(t))
            else:
                cols.append(math.perm(k, d) * t ** (k - d))
        return torch.stack(cols, -1)

    zero = torch.zeros(lead, dtype=sol_dt, device=T.device)
    r = 0
    for d in range(3):
        A[..., r, 0:NC] = row_at(zero, d)
        b[..., r, :] = head[..., :, d].to(sol_dt)
        r += 1
    for i in range(N - 1):
        Ti = Tw[..., i]
        ci = slice(NC * i, NC * i + NC)
        cn = slice(NC * i + NC, NC * i + 2 * NC)
        A[..., r, ci] = row_at(Ti, 0)
        b[..., r, :] = q[..., i, :].to(sol_dt)
        r += 1
        for d in range(5):
            A[..., r, ci] = row_at(Ti, d)
            A[..., r, cn] = -row_at(zero, d)
            r += 1
    for d in range(3):
        A[..., r, NC * (N - 1):] = row_at(Tw[..., N - 1], d)
        b[..., r, :] = tail[..., :, d].to(sol_dt)
        r += 1
    c = torch.linalg.solve(A, b)
    return c.reshape(lead + (N, NC, 3)).to(dt)


def waypoints(c):
    """Interior junction positions of a trajectory: the pieces' starts."""
    return c[..., 1:, 0, :]


def poly_derivs(c, s, orders=(0, 1, 2, 3)):
    """Derivatives of each piece's polynomial at local times s (..., N, M)
    -> tuple of (..., N, M, 3)."""
    out = []
    for d in orders:
        acc = torch.zeros(s.shape + (3,), dtype=s.dtype, device=s.device)
        for k in range(NC - 1, d - 1, -1):          # Horner
            acc = acc * s[..., None] + math.perm(k, d) * c[..., k, None, :]
        out.append(acc)
    return tuple(out)


def at_times(c, T, t):
    """Position, velocity, acceleration and jerk at global times t (..., M)
    of trajectories (..., N) -> four (..., M, 3)."""
    cum = torch.cumsum(T, -1)
    starts = cum - T
    tc = torch.minimum(torch.clamp(t, min=0.0), cum[..., -1:])
    idx = torch.searchsorted(cum.contiguous(), tc.contiguous())
    idx = idx.clamp(max=T.shape[-1] - 1)
    s = tc - torch.gather(starts, -1, idx)
    ci = torch.gather(c, -3, idx[..., None, None].expand(
        idx.shape + c.shape[-2:]))                   # (..., M, 6, 3)
    out = []
    for d in range(4):
        acc = torch.zeros(s.shape + (3,), dtype=s.dtype, device=s.device)
        for k in range(NC - 1, d - 1, -1):
            acc = acc * s[..., None] + math.perm(k, d) * ci[..., k, :]
        out.append(acc)
    return tuple(out)


def tilt(vel, acc, phys):
    """The body's z axis under drag, z = zu / |zu| with
    zu = a + (dh/m)(1 + cp sqrt(|v|^2 + eps)) v + g e3, and its helpers."""
    sp = torch.sqrt((vel * vel).sum(-1, keepdim=True) + phys["veps"])
    wt = 1.0 + phys["cp"] * sp
    zu = acc + (phys["dh"] / phys["mass"]) * wt * vel
    zu = torch.cat([zu[..., :2], zu[..., 2:] + phys["grav"]], -1)
    nz = torch.sqrt((zu * zu).sum(-1, keepdim=True))
    return zu / nz, nz, sp, wt


def tilt_rotation(vel, acc, phys):
    """R of the zero-yaw tilt taking e3 to z (the quaternion
    (sqrt((1+z3)/2), -z2/d, z1/d, 0), d = sqrt(2(1+z3)))."""
    z, _, _, _ = tilt(vel, acc, phys)
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    d = torch.sqrt(2.0 * (1.0 + z3))
    w, x, y = 0.5 * d, -z2 / d, z1 / d
    R = torch.stack([
        w * w + x * x - y * y, 2 * x * y, 2 * w * y,
        2 * x * y, w * w - x * x + y * y, -2 * w * x,
        -2 * w * y, 2 * w * x, w * w - x * x - y * y], -1)
    return R.reshape(z.shape[:-1] + (3, 3))


def rates(vel, acc, jer, phys):
    """(cos of the tilt angle, body rate omega) of the drag-augmented
    flatness map."""
    z, nz, sp, wt = tilt(vel, acc, phys)
    va = (vel * acc).sum(-1, keepdim=True)
    dw = wt * acc + (phys["cp"] * va / sp) * vel
    dzu = jer + (phys["dh"] / phys["mass"]) * dw
    dz = (dzu - z * (z * dzu).sum(-1, keepdim=True)) / nz
    z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2]
    d1, d2, d3 = dz[..., 0], dz[..., 1], dz[..., 2]
    den = z3 + 1.0
    omg = torch.stack([-d2 + z2 * d3 / den, d1 - z1 * d3 / den,
                       (z2 * d1 - z1 * d2) / den], -1)
    # cos(theta) = 1 - 2 (x^2 + y^2) of the tilt quaternion = z3
    return z3, omg


def hinge(x, mu):
    """The C1 hinge: 0 for x <= 0, (mu - x/2)(x/mu)^3 on (0, mu),
    x - mu/2 beyond."""
    xc = torch.clamp(x, 0.0, mu)
    blend = (mu - 0.5 * xc) * (xc / mu) ** 3
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x >= mu, x - 0.5 * mu, blend))


def energy(c, T):
    """sum_i int_0^T_i |p'''|^2 dt, in closed form."""
    a = torch.stack([c[..., 3, :] * 6.0, c[..., 4, :] * 24.0,
                     c[..., 5, :] * 60.0], -2)       # jerk's s^0, s^1, s^2
    e = torch.zeros_like(T)
    for m in range(3):
        for n in range(3):
            e = e + (a[..., m, :] * a[..., n, :]).sum(-1) \
                * T ** (m + n + 1) / (m + n + 1)
    return e.sum(-1)


def feasibility(c, T, w, phys, res):
    """The dynamic-feasibility penalty, a trapezoid sum over res + 1
    samples of each piece of the speed, body-rate and tilt hinges."""
    frac = torch.arange(res + 1, dtype=T.dtype, device=T.device) / res
    s = T[..., None] * frac                            # (..., N, res+1)
    _, vel, acc, jer = poly_derivs(c, s)
    cos_t, omg = rates(vel, acc, jer, phys)
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-6, 1.0 - 1e-6))
    mu = w["smoothingEps"]
    pena = (w["weight_v"] * hinge((vel * vel).sum(-1) - w["vmax"] ** 2, mu)
            + w["weight_omg"] * hinge((omg * omg).sum(-1) - w["omgmax"] ** 2,
                                      mu)
            + w["weight_theta"] * hinge(theta - w["thetamax"], mu))
    node = torch.ones(res + 1, dtype=T.dtype, device=T.device)
    node[0] = node[-1] = 0.5
    return (pena * node * (T / res)[..., None]).sum((-1, -2))


def safety(sv, mask, w):
    """The swept-volume penalty over the obstacle points in ``mask``."""
    pena = w["weight_p"] * hinge(w["safety_hor"] - sv, 0.01)
    return torch.where(mask, pena, torch.zeros_like(pena)).sum(-1)


def cost_terms(c, T, sv, mask, w, phys, res):
    """The back end's cost of trajectories whose swept SDF at the obstacle
    points is sv: energy + rho sum T + feasibility + safety."""
    return (energy(c, T) + w["rho"] * T.sum(-1)
            + feasibility(c, T, w, phys, res) + safety(sv, mask, w))
