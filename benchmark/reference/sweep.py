"""The swept-volume SDF, SV(p) = min over t of body(R(t)^T (p - x(t))),
by brute force: every point against a dense grid of times, then a
golden-section search around the best grid time."""

from __future__ import annotations

import math

import torch

from benchmark.reference import traj as rt

DT = 0.005            # seconds between the dense grid's times
GOLDEN_ITERS = 40


def swept_sdf(body, c, T, pts, phys, chunk: int = 1 << 22):
    """SV of points pts (B, P, 3) for trajectories (c (B, N, 6, 3),
    T (B, N)) -> (sv (B, P), t* (B, P))."""
    B, P, _ = pts.shape
    dt, dev = pts.dtype, pts.device
    total = T.sum(-1)
    M = max(int(math.ceil(float(total.max()) / DT)) + 1, 64)
    frac = torch.linspace(0.0, 1.0, M, dtype=dt, device=dev)
    ts = total[:, None] * frac                              # (B, M)
    pos, vel, acc, _ = rt.at_times(c, T, ts)
    R = rt.tilt_rotation(vel, acc, phys)                    # (B, M, 3, 3)
    best = torch.full((B, P), float("inf"), dtype=dt, device=dev)
    arg = torch.zeros((B, P), dtype=torch.long, device=dev)
    step = max(1, chunk // max(B * P, 1))     # times per block
    for m0 in range(0, M, step):
        m1 = min(M, m0 + step)
        rel = torch.einsum("bmji,bmpj->bmpi", R[:, m0:m1],
                           pts[:, None] - pos[:, m0:m1, None])
        d = body(rel)                                       # (B, m, P)
        v, j = d.min(1)
        take = v < best
        best = torch.where(take, v, best)
        arg = torch.where(take, j + m0, arg)
    h = total[:, None] / (M - 1)
    lo = torch.clamp(torch.gather(ts, 1, arg) - h, min=0.0)
    hi = torch.minimum(torch.gather(ts, 1, arg) + h, total[:, None])

    def f(t):
        return sdf_at(body, c, T, pts, t, phys)

    g = (math.sqrt(5.0) - 1.0) / 2.0
    x1, x2 = hi - g * (hi - lo), lo + g * (hi - lo)
    f1, f2 = f(x1), f(x2)
    for _ in range(GOLDEN_ITERS):
        left = f1 <= f2                 # the minimum lies in [lo, x2]
        lo, hi = torch.where(left, lo, x1), torch.where(left, x2, hi)
        n1 = torch.where(left, hi - g * (hi - lo), x2)
        n2 = torch.where(left, x1, lo + g * (hi - lo))
        fn = f(torch.where(left, n1, n2))
        f1, f2 = torch.where(left, fn, f2), torch.where(left, f1, fn)
        x1, x2 = n1, n2
    # the search's best against the grid's: never worse than the grid
    tm = 0.5 * (lo + hi)
    fm = f(tm)
    sv = torch.minimum(fm, best)
    return sv, torch.where(fm <= best, tm, torch.gather(ts, 1, arg))


def sdf_at(body, c, T, pts, t, phys):
    """The body's SDF at points pts (B, P, 3) at times t (B, P) of
    trajectories (c, T) -> (B, P)."""
    p, v, a, _ = rt.at_times(c, T, t)
    Rt = rt.tilt_rotation(v, a, phys)
    rel = torch.einsum("bpji,bpj->bpi", Rt, pts - p)
    return body(rel)
