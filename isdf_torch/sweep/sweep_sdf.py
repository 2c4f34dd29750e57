"""Swept-volume SDF:  SV(p) = min_t SDF_body(R(t)ᵀ (p − x(t)))
(counterpart of ``isdf_tpu/sweep/sweep_sdf.py``, as its TPU dispatch runs it).

Analytic shapes go through K1 (sweep/fused_zoom.py): one launch does the
shared coarse scan, the warm and the cold zoom, the branch pick and the
gradient at t*.  The differentiable value is then SDF(p, t*) evaluated with
autograd at the frozen t* (envelope theorem — the reference treats t* as a
constant in its gradient, back_end_optimizer.hpp:827).

The grid (mesh robot) and pooled branches wait for K3.
"""

from __future__ import annotations

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.device import check_on, resolve_device
from isdf_torch.sweep import fused_zoom
from isdf_torch.sweep.fast_eval import sdf_at_time_c


def traj_states(traj, params, ts):
    """Poses (x, R) at times ts (T,) → ((T, 3), (T, 3, 3))."""
    pos, vel, acc, jer = traj.pvaj(ts)
    return fl.pose_of(pos, vel, acc, jer, params)


def _sweep_fused(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
                 warm_window):
    """K1 launch + one differentiable re-evaluation at t*.

    On the card the kernel runs in float32, as the Pallas kernel does; the
    results come back in the working dtype."""
    dtype = p_eva.dtype
    kdtype = torch.float32 if p_eva.is_cuda else dtype
    with torch.no_grad():
        total = traj.total_duration
        ts = torch.linspace(0.0, 1.0, coarse_n, dtype=dtype,
                            device=p_eva.device) * total
        xs, Rs = traj_states(traj.detach(), params, ts)
        pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1)
        durs = traj.durations.detach()
        starts = torch.cumsum(durs, 0) - durs
        t_star, _, grad_prel = fused_zoom.sweep_warm_fused(
            shape, params,
            *(a.to(kdtype).contiguous() for a in (
                p_eva.detach(), t_warm.detach(), pose, starts, durs,
                traj.coeffs.detach())),
            coarse_n=coarse_n, rounds=refine_rounds, warm_window=warm_window)
    t_star = t_star.to(dtype)
    pw = (p_eva[:, 0], p_eva[:, 1], p_eva[:, 2])
    sdf_star = sdf_at_time_c(shape, traj, params, pw, t_star)
    return sdf_star, t_star, grad_prel.to(dtype)


def sweep_sdf(shape, traj, params, p_eva, coarse_n: int = 128,
              refine_rounds: int = 24, device=None):
    """Swept-volume SDF for a batch of points (cold start) →
    (sdf* (P,), t* (P,), grad_prel (P, 3)).  As on the TPU, the cold sweep is
    the warm sweep seeded at t = 0 with window 0.3: the coarse branch gives
    the global argmin, the warm branch costs one redundant zoom."""
    dev = resolve_device(device)
    check_on(dev, p_eva=p_eva, durations=traj.durations)
    return _sweep_fused(shape, traj, params, p_eva,
                        torch.zeros_like(p_eva[:, 0]), coarse_n,
                        refine_rounds, 0.3)


def sweep_sdf_warm(shape, traj, params, p_eva, t_warm, coarse_n: int = 64,
                   refine_rounds: int = 16, warm_window: float = 0.3,
                   device=None):
    """Warm-started swept SDF: zoom around t_warm AND re-scan coarsely; the
    deeper minimum wins (guards against topology changes between outer
    iterations)."""
    dev = resolve_device(device)
    check_on(dev, p_eva=p_eva, t_warm=t_warm, durations=traj.durations)
    return _sweep_fused(shape, traj, params, p_eva, t_warm, coarse_n,
                        refine_rounds, warm_window)
