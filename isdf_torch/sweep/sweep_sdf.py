"""Swept-volume SDF:  SV(p) = min_t SDF_body(R(t)ᵀ (p − x(t)))
(counterpart of ``isdf_tpu/sweep/sweep_sdf.py``, as its TPU dispatch runs it).

Analytic shapes go through K1 (sweep/fused_zoom.py): one launch does the
shared coarse scan, the warm and the cold zoom, the branch pick and the
gradient at t*.  A batch of scenarios (a trajectory with a leading B axis,
points (B, P, 3)) goes through K2, one launch for all scenarios.  The
differentiable value is then SDF(p, t*) evaluated with autograd at the
frozen t* (envelope theorem — the reference treats t* as a constant in its
gradient, back_end_optimizer.hpp:827).

Mesh robots (a shape with a ``grid``, shapes/gridsdf.py) go through K3
(sweep/grid_zoom.py), single or batched, at every field size: the TPU's
pooled branch for fields beyond its VMEM budget has no counterpart here.
The warm sweep's differentiable value is the linearisation of the body SDF
at the kernel's epilogue point, d* + g*·(p_rel(θ, t*) − p_rel*); the cold
sweep (audits) takes only t* from K3 and re-evaluates the value through the
trilinear interpolation and its gradient with autograd.
"""

from __future__ import annotations

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.device import check_on, resolve_device
from isdf_torch.sweep import fused_zoom, grid_zoom
from isdf_torch.sweep.fast_eval import (
    pose_components, pvaj_components, rel_components, sdf_at_time_c)


def traj_states(traj, params, ts):
    """Poses (x, R) at times ts (T,) → ((T, 3), (T, 3, 3)); for a batched
    traj, ts (B, T) → ((B, T, 3), (B, T, 3, 3))."""
    pos, vel, acc, jer = traj.pvaj(ts)
    return fl.pose_of(pos, vel, acc, jer, params)


def _sweep_fused(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
                 warm_window):
    """One kernel launch + one differentiable re-evaluation at t*: K1 for one
    trajectory (p_eva (P, 3)), K2 for a batch (p_eva (B, P, 3), each
    scenario with its own pose table and durations).

    On the card the kernel runs in float32, as the Pallas kernel does; the
    results come back in the working dtype."""
    dtype = p_eva.dtype
    kdtype = torch.float32 if p_eva.is_cuda else dtype
    kernel = (fused_zoom.sweep_warm_fused_batched if traj.batched
              else fused_zoom.sweep_warm_fused)
    with torch.no_grad():
        total = traj.total_duration
        ts = torch.linspace(0.0, 1.0, coarse_n, dtype=dtype,
                            device=p_eva.device) * total[..., None]
        xs, Rs = traj_states(traj.detach(), params, ts)
        pose = torch.cat([xs, Rs.flatten(-2)], dim=-1)
        durs = traj.durations.detach()
        starts = torch.cumsum(durs, -1) - durs
        t_star, _, grad_prel = kernel(
            shape, params,
            *(a.to(kdtype).contiguous() for a in (
                p_eva.detach(), t_warm.detach(), pose, starts, durs,
                traj.coeffs.detach())),
            coarse_n=coarse_n, rounds=refine_rounds, warm_window=warm_window)
    t_star = t_star.to(dtype)
    pw = (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2])
    sdf_star = sdf_at_time_c(shape, traj, params, pw, t_star)
    return sdf_star, t_star, grad_prel.to(dtype)


def _grid_kernel(shape, traj, params, p_eva, t_warm, coarse_n,
                 refine_rounds, warm_window):
    """One K3 launch on the shape's field → (t*, d*, g*) in the working
    dtype, all constants of the graph (float32 on the card)."""
    dtype = p_eva.dtype
    kdtype = torch.float32 if p_eva.is_cuda else dtype
    kernel = (grid_zoom.grid_sweep_warm_fused_batched if traj.batched
              else grid_zoom.grid_sweep_warm_fused)
    with torch.no_grad():
        durs = traj.durations.detach()
        starts = torch.cumsum(durs, -1) - durs
        out = kernel(
            shape.grid, params,
            *(a.to(kdtype).contiguous() for a in (
                p_eva.detach(), t_warm.detach(), starts, durs,
                traj.coeffs.detach())),
            coarse_n=coarse_n, rounds=refine_rounds, warm_window=warm_window)
    return tuple(a.to(dtype) for a in out)


def _grid_sweep_fused(shape, traj, params, p_eva, t_warm, coarse_n,
                      refine_rounds, warm_window):
    """K3 warm sweep: the differentiable value is the linearisation of the
    body SDF at the epilogue point, sdf(p_rel) ≈ d* + g*·(p_rel − p_rel*),
    with (d*, g*, p_rel*) constants and p_rel(traj, p, t*) the
    differentiable pose chain — how the reference consumes (sdf_value,
    gradp_rel) pairs (back_end_optimizer.hpp:619-627).  The value equals d*;
    the voxel field is not read outside the kernel."""
    t_star, d0, g0 = _grid_kernel(shape, traj, params, p_eva, t_warm,
                                  coarse_n, refine_rounds, warm_window)
    pw = (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2])
    pos, vel, acc, _ = pvaj_components(traj, t_star, n_orders=3)
    x3, R = pose_components(pos, vel, acc, params)
    rx, ry, rz = rel_components(pw, x3, R)
    sdf_star = (d0 + g0[..., 0] * (rx - rx.detach())
                + g0[..., 1] * (ry - ry.detach())
                + g0[..., 2] * (rz - rz.detach()))
    return sdf_star, t_star, g0


def _grad_prel(shape, traj, params, p_eva, t_star):
    """∂SDF/∂p_rel at the argmin pose (ref getGradPrelAtTimeStamp,
    sw_manager.hpp:566-572), by autograd of the body SDF."""
    with torch.no_grad():
        pos, vel, acc, _ = pvaj_components(traj.detach(), t_star, n_orders=3)
        x3, R = pose_components(pos, vel, acc, params)
        prel = rel_components(
            (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2]), x3, R)
    return shape.grad(torch.stack(prel, dim=-1))


def sweep_sdf(shape, traj, params, p_eva, coarse_n: int = 128,
              refine_rounds: int = 24, device=None):
    """Swept-volume SDF for a batch of points (cold start) →
    (sdf* (P,), t* (P,), grad_prel (P, 3)); with a batched traj and p_eva
    (B, P, 3), each with a leading B.  As on the TPU, the cold sweep is
    the warm sweep seeded at t = 0 with window 0.3: the coarse branch gives
    the global argmin, the warm branch costs one redundant zoom.  For a mesh
    robot K3 gives t*, and the value is the float32 (or working-dtype)
    trilinear interpolation at t*: audits carry no kernel rounding."""
    dev = resolve_device(device)
    check_on(dev, p_eva=p_eva, durations=traj.durations)
    t_warm = torch.zeros_like(p_eva[..., 0])
    if shape.grid is not None:
        t_star, _, _ = _grid_kernel(shape, traj, params, p_eva, t_warm,
                                    coarse_n, refine_rounds, 0.3)
        pw = (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2])
        sdf_star = sdf_at_time_c(shape, traj, params, pw, t_star)
        return sdf_star, t_star, _grad_prel(shape, traj, params, p_eva,
                                            t_star)
    return _sweep_fused(shape, traj, params, p_eva, t_warm, coarse_n,
                        refine_rounds, 0.3)


def sweep_sdf_warm(shape, traj, params, p_eva, t_warm, coarse_n: int = 64,
                   refine_rounds: int = 16, warm_window: float = 0.3,
                   device=None):
    """Warm-started swept SDF: zoom around t_warm AND re-scan coarsely; the
    deeper minimum wins (guards against topology changes between outer
    iterations)."""
    dev = resolve_device(device)
    check_on(dev, p_eva=p_eva, t_warm=t_warm, durations=traj.durations)
    sweep = _grid_sweep_fused if shape.grid is not None else _sweep_fused
    return sweep(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
                 warm_window)
