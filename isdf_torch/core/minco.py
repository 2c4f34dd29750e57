"""MINCO minimum-control-effort trajectories (counterpart of
``isdf_tpu/core/minco.py``).

The map (waypoints q[N-1], times T[N]) → coefficients c solves a linear
system of boundary conditions, waypoint interpolation and C^{2s-2}
continuity.  It is assembled dense (2sN × 2sN) and solved with
``torch.linalg.solve``; autograd through the solve replaces the reference's
hand-written adjoint.
"""

from __future__ import annotations

import math

import torch


def _beta(t: torch.Tensor, n_coef: int, order: int) -> torch.Tensor:
    """β_order(t) rows, shape t.shape + (n_coef,): β·c = d^order p / dt^order."""
    cols = []
    for k in range(n_coef):
        if k < order:
            cols.append(torch.zeros_like(t))
            continue
        f = math.factorial(k) / math.factorial(k - order)
        p = torch.ones_like(t)
        for _ in range(k - order):
            p = p * t
        cols.append(f * p)
    return torch.stack(cols, dim=-1)


def build_system(q, T, head, tail, s: int = 3):
    """Dense MINCO system (A (..., 2sN, 2sN), rhs (..., 2sN, 3)).

    q (..., N-1, 3) interior waypoints, T (..., N) durations, head/tail
    (..., 3, s) columns pos/vel/... at the ends; any leading axes (the
    scenario axis of parallel/batch.py) are carried through.  Row layout per
    interior junction: continuity of orders s..2s-2, the waypoint row,
    continuity of orders 0..s-1."""
    dtype, dev = T.dtype, T.device
    lead = tuple(T.shape[:-1])
    N = T.shape[-1]
    nc = 2 * s
    dim = nc * N
    A = torch.zeros(lead + (dim, dim), dtype=dtype, device=dev)
    rhs = torch.zeros(lead + (dim, 3), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    b0 = [_beta(zero, nc, d) for d in range(nc)]
    # (..., N, order, nc)
    bT = torch.stack([_beta(T, nc, d) for d in range(nc)], dim=-2)

    for d in range(s):
        A[..., d, :nc] = b0[d]
        rhs[..., d, :] = head[..., :, d]

    if N > 1:
        i = torch.arange(N - 1, device=dev)
        base = nc * i
        cols_i = base[:, None] + torch.arange(nc, device=dev)[None, :]
        cols_n = cols_i + nc
        row0 = base + s
        orders = list(range(s, 2 * s - 1))
        for j, d in enumerate(orders):
            r = (row0 + j)[:, None]
            A[..., r, cols_i] = bT[..., :-1, d, :]
            A[..., r, cols_n] = -b0[d].expand(N - 1, nc)
        r = row0 + len(orders)
        A[..., r[:, None], cols_i] = bT[..., :-1, 0, :]
        rhs[..., r, :] = q
        for j, d in enumerate(range(s)):
            r = (row0 + len(orders) + 1 + j)[:, None]
            A[..., r, cols_i] = bT[..., :-1, d, :]
            A[..., r, cols_n] = -b0[d].expand(N - 1, nc)

    for d in range(s):
        r = dim - s + d
        A[..., r, dim - nc:dim] = bT[..., -1, d, :]
        rhs[..., r, :] = tail[..., :, d]
    return A, rhs


def solve(q, T, head, tail, s: int = 3) -> torch.Tensor:
    """(q, T) → coefficients (..., N, 2s, 3), ascending powers.  With a
    leading scenario axis ``torch.linalg.solve_ex`` takes the batch of
    systems.  A singular system (durations overflowed by a far line-search
    trial) gives NaN coefficients, as the JAX package's solve does, and the
    optimizer rejects the trial; nothing raises or waits for the card."""
    A, rhs = build_system(q, T, head, tail, s)
    c, info = torch.linalg.solve_ex(A, rhs)
    c = torch.where((info == 0)[..., None, None], c,
                    torch.full_like(c, math.nan))
    return c.reshape(tuple(T.shape) + (2 * s, 3))


def energy(coeffs, T, s: int = 3) -> torch.Tensor:
    """Σ_i ∫_0^{T_i} ‖d^s p/dt^s‖² dt in closed form, per leading index
    (a 0-d tensor for one trajectory, (B,) for a batch)."""
    dtype, dev = T.dtype, T.device
    nc = 2 * s
    fact = torch.tensor(
        [math.factorial(m + s) / math.factorial(m) for m in range(s)],
        dtype=dtype, device=dev)
    g = coeffs[..., s:nc, :] * fact[:, None]                 # (..., N, s, 3)
    m = torch.arange(s, device=dev)
    mn = (m[:, None] + m[None, :] + 1).to(dtype)               # (s, s)
    w = torch.pow(T[..., None, None], mn) / mn
    gram = torch.einsum("...md,...kd->...mk", g, g)
    return sum_last(gram * w, 3)


def sum_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Sum over the last n axes; one trajectory (exactly n axes) takes the
    full reduction it always took."""
    return torch.sum(x) if x.dim() == n else x.flatten(-n).sum(-1)
