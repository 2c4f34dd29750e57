"""Attitude-reference tracking penalty, shared by mid end and back end
(counterpart of ``isdf_tpu/opt/attitude.py``; see opt/midend.py)."""

from __future__ import annotations

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core.poly import PolyTraj, beta
from isdf_torch.core.smoothing import smoothed_l1, vabs
from isdf_torch.core.so3 import exp_rotvec, log_rot, quat_to_rot


def wc2(x: torch.Tensor) -> torch.Tensor:
    """C¹ window: 1 at x=0 falling to 0 at |x|≥1 (ref mid_end.hpp:394-421).
    Piecewise 0 | 2(x+1)² | 1−2x² | 2(x−1)² | 0 on
    (−∞,−1] [−1,−½] [−½,½] [½,1] [1,∞)."""
    inner = torch.where(
        x < -0.5, 2.0 * (x + 1.0) ** 2,
        torch.where(x < 0.5, 1.0 - 2.0 * x * x, 2.0 * (x - 1.0) ** 2))
    return torch.where(vabs(x) >= 1.0, torch.zeros_like(x), inner)


def attitude_cost(quat, rot_ref):
    """2(3 − tr(R_refᵀ R(q)))."""
    R = quat_to_rot(quat)
    return 2.0 * (3.0 - torch.einsum("...ij,...ij->...", rot_ref, R))


def attitude_penalty(traj: PolyTraj, params, att, w_ar: float,
                     smooth_fac: float, res: int, bridge: bool = True):
    """WC2-windowed attitude tracking over pieces × (res+1) samples
    (ref addTimeIntPenalty mid_end.hpp:476-595, attitude part).

    att: (N+1, 3, 3) junction references.  With ``bridge``, pieces whose
    two junction references are both non-identity get full weight across the
    piece and track the rotation-vector lerp between them."""
    T = traj.durations
    j = torch.arange(res + 1, device=T.device)
    frac = (j / res).to(T.dtype)
    s = T[:, None] * frac[None, :]                      # (N, res+1)
    c = traj.coeffs

    def eval_d(order):
        return torch.einsum("nsk,nkd->nsd", beta(s, order), c)

    pos, vel, acc, jer = eval_d(0), eval_d(1), eval_d(2), eval_d(3)
    quat, _ = fl.rates_of(pos, vel, acc, jer, params)

    midT = 0.5 * T[:, None]
    is_left = s <= midT
    xw = torch.where(is_left, s / midT, (s - midT) / midT - 1.0)
    k = wc2(xw)
    if bridge:
        rv = log_rot(att)                               # (N+1, 3)
        rv_l, rv_r = rv[:-1], rv[1:]
        nonid = torch.sum(rv * rv, dim=-1) > 1e-10
        full = (nonid[:-1] & nonid[1:]).to(T.dtype)
        k = torch.maximum(k, full[:, None].expand_as(k))
        rv_s = (1.0 - frac)[None, :, None] * rv_l[:, None] \
            + frac[None, :, None] * rv_r[:, None]
        ref = exp_rotvec(rv_s)
    else:
        ref = torch.where(is_left[..., None, None], att[:-1, None],
                          att[1:, None])
    ca = attitude_cost(quat, ref)
    pena = k * w_ar * smoothed_l1(ca, smooth_fac)
    node = torch.where((j == 0) | (j == res), 0.5, 1.0).to(T.dtype)
    step = T / res
    return torch.sum(pena * node[None, :] * step[:, None])


def pad_attitude_refs(rot_refs, dtype=None, device=None):
    """(N−1, 3, 3) waypoint refs → (N+1, 3, 3) with identity head/tail."""
    rot_refs = torch.as_tensor(rot_refs, dtype=dtype, device=device)
    eye = torch.eye(3, dtype=rot_refs.dtype, device=rot_refs.device)[None]
    return torch.cat([eye, rot_refs, eye], dim=0)
