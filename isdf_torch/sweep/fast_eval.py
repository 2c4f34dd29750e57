"""Component-form trajectory-state evaluation for the swept SDF
(counterpart of ``isdf_tpu/sweep/fast_eval.py``).

Components travel as separate tensors shaped like the query times; the
located piece is gathered (the TPU twin sums all pieces under masks because
gathers scalarize there — on the GPU a gather is cheap).
"""

from __future__ import annotations

import torch

from isdf_torch.core.poly import take_pieces
from isdf_torch.core.smoothing import clip


def _fact_ratio(k: int, d: int) -> float:
    r = 1.0
    for j in range(k, k - d, -1):
        r *= j
    return r


def piece_index(cum: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """idx = #{n < N-1 : t > cum[n]} — the kernel's piece rule.  cum (N,)
    with t of any shape, or a batch cum (B, N) with t (B, M), each row
    against its own boundaries."""
    n = cum.shape[-1]
    if cum.dim() == 2:
        return torch.searchsorted(cum[:, :n - 1].contiguous(),
                                  t.detach().contiguous())
    return torch.searchsorted(cum[:n - 1].contiguous(),
                              t.detach().reshape(-1)).reshape(t.shape)


def pvaj_tables(starts, durs, cum, coeffs, t: torch.Tensor,
                n_orders: int = 3):
    """pos/vel/acc[/jerk] components at global times t from the piece tables
    (starts, durations, cumulative ends, coeffs (N, n_coef, 3)): the located
    piece only, Horner on derivative-folded coefficients.  Returns
    ``n_orders`` 3-tuples of tensors shaped like t.  With a leading scenario
    axis on the tables ((B, N), (B, N, n_coef, 3)) t is (B, M) and each row
    is evaluated on its own scenario's pieces."""
    batched = cum.dim() == 2
    n_coef = coeffs.shape[-2]
    total = cum[:, -1:] if batched else cum[-1]
    tc = clip(t, 0.0, total).detach()
    idx = piece_index(cum, tc)
    s = clip(t - take_pieces(starts, idx, batched), 0.0,
             take_pieces(durs, idx, batched))
    c = take_pieces(coeffs, idx, batched)             # t.shape + (n_coef, 3)
    result = []
    for d in range(n_orders):
        if d >= n_coef:
            z = torch.zeros_like(t)
            result.append((z, z, z))
            continue
        comps = []
        for ax in range(3):
            cd = [c[..., k, ax] * _fact_ratio(k, d) if d else c[..., k, ax]
                  for k in range(d, n_coef)]
            acc = cd[-1]
            for k in range(len(cd) - 2, -1, -1):
                acc = acc * s + cd[k]
            comps.append(acc)
        result.append(tuple(comps))
    return tuple(result)


def pvaj_components(traj, t: torch.Tensor, n_orders: int = 3):
    """pos/vel/acc[/jerk] components at global times t (for a batched traj,
    t (B, M)).  Returns ``n_orders`` 3-tuples of tensors shaped like t
    (padded with zeros to 4)."""
    dtype = t.dtype
    durations = traj.durations.to(dtype)
    cum = torch.cumsum(durations, -1)
    starts = cum - durations
    result = list(pvaj_tables(starts, durations, cum, traj.coeffs.to(dtype),
                              t, n_orders))
    zero = torch.zeros_like(t)
    while len(result) < 4:
        result.append((zero, zero, zero))
    return tuple(result)


def pose_components(pos, vel, acc, params):
    """Component-form pose map: 3-tuples → (pos3 3-tuple, R 9-tuple, row
    major).  Quadrotor tilt from the drag-augmented specific force."""
    p = params
    vx, vy, vz = vel
    ax, ay, az = acc
    cp_term = torch.sqrt(vx * vx + vy * vy + vz * vz + p.veps)
    w_term = 1.0 + p.cp * cp_term
    k = p.dh / p.mass
    zux = ax + k * w_term * vx
    zuy = ay + k * w_term * vy
    zuz = az + k * w_term * vz + p.grav
    izn = torch.rsqrt(zux * zux + zuy * zuy + zuz * zuz)
    zx, zy, zz = zux * izn, zuy * izn, zuz * izn

    td2 = 2.0 * (1.0 + zz)
    itd = torch.rsqrt(td2)
    qw = 0.5 * td2 * itd
    qx = -zy * itd
    qy = zx * itd
    ww, xx, yy = qw * qw, qx * qx, qy * qy
    xy2, wx2, wy2 = 2 * qx * qy, 2 * qw * qx, 2 * qw * qy
    R = (
        ww + xx - yy, xy2, wy2,
        xy2, ww - xx + yy, -wx2,
        -wy2, wx2, ww - xx - yy,
    )
    return tuple(pos), R


def rel_components(p_world, x3, R):
    """p_rel = Rᵀ (p − x), all component-form (broadcasting)."""
    dx = p_world[0] - x3[0]
    dy = p_world[1] - x3[1]
    dz = p_world[2] - x3[2]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
    return (
        r00 * dx + r10 * dy + r20 * dz,
        r01 * dx + r11 * dy + r21 * dz,
        r02 * dx + r12 * dy + r22 * dz,
    )


def sdf_at_time_c(shape, traj, params, p_world, t):
    """Component-form body SDF at trajectory time(s); p_world is a 3-tuple
    broadcasting against t.  Differentiable in traj and p_world."""
    pos, vel, acc, _ = pvaj_components(traj, t, n_orders=3)
    x3, R = pose_components(pos, vel, acc, params)
    prel = rel_components(p_world, x3, R)
    return shape.sdf3_fn()(*prel)
