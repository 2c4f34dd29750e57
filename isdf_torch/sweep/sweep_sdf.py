"""Swept-volume SDF:  SV(p) = min_t SDF_body(R(t)ᵀ (p − x(t)))
(counterpart of ``isdf_tpu/sweep/sweep_sdf.py``, as its TPU dispatch runs it).

Analytic shapes go through K1 (sweep/fused_zoom.py): one launch does the
shared coarse scan, the warm and the cold zoom, the branch pick and the
gradient at t*.  A batch of scenarios (a trajectory with a leading B axis,
points (B, P, 3)) goes through K2, one launch for all scenarios.  The
differentiable value is then SDF(p, t*) evaluated with autograd at the
frozen t* (envelope theorem — the reference treats t* as a constant in its
gradient, back_end_optimizer.hpp:827).

Either pose map of core/flatness reaches the kernels: FlatParams (the
quadrotor tilt) or PlanarPose (SE(2), the planar planner's); on CUDA tensors
both launch K1/K2/K3, on CPU tensors both run the plain versions.

Mesh robots (a shape with a ``grid``, shapes/gridsdf.py) go through K3
(sweep/grid_zoom.py), single or batched, at every field size: the TPU's
pooled branch for fields beyond its VMEM budget has no counterpart here.
The warm sweep's differentiable value is the linearisation of the body SDF
at the kernel's epilogue point, d* + g*·(p_rel(θ, t*) − p_rel*); the cold
sweep (audits) takes only t* from K3 and re-evaluates the value through the
trilinear interpolation and its gradient with autograd.

A warm kernel sweep is three steps, so that the back end can hold the
first and the last in CUDA graphs around the eager launch:
:func:`kernel_args` (no grad), :func:`launch` and :func:`sweep_value`.

The kernels take coarse_n in multiples of 8 and shapes they can compile
(a ``ShapeSpec``, or a baked field).  Every other sweep runs the JAX
package's non-fused path in PyTorch operations, as JAX runs it off the TPU
and for every shape its kernels refuse: the coarse table over the pose rows,
its first minimum, then the fixed-round plateau zooms (``_zoom``).  The
choice is made up front from coarse_n and the shape (:func:`kernel_ok`);
``XLA_CALLS`` counts the sweeps that took this path.
"""

from __future__ import annotations

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.device import check_on, resolve_device
from isdf_torch.sweep import fused_zoom, grid_zoom, pieces
from isdf_torch.sweep.fast_eval import (
    pvaj_components, rel_at_state, rel_components, sdf_at_time_c)

# sweeps (sweep_sdf / sweep_sdf_warm calls) that took the non-fused path
# since the caller last set it to 0
XLA_CALLS = 0


def traj_states(traj, params, ts):
    """Poses (x, R) at times ts (T,) → ((T, 3), (T, 3, 3)); for a batched
    traj, ts (B, T) → ((B, T, 3), (B, T, 3, 3)).  ``params`` selects the
    pose map: FlatParams → quadrotor tilt, PlanarPose → SE(2), whose x
    column 2 is z_ref (the trajectory's third axis is the yaw)."""
    pos, vel, acc, jer = traj.pvaj(ts)
    return fl.pose_of(pos, vel, acc, jer, params)


def sdf_at_time(shape, traj, params, p_eva, t):
    """SDF of the body at trajectory time(s) t for world point(s) p_eva,
    differentiable in the trajectory, the points and t: what the penalty
    evaluates at the frozen t* (envelope theorem)."""
    pos, vel, acc, jer = traj.pvaj(t)
    pos3, R = fl.pose_of(pos, vel, acc, jer, params)
    p_rel = torch.einsum("...ji,...j->...i", R, p_eva - pos3)
    return shape.sdf(p_rel)


def sweep_sdf_dot(shape, traj, params, p_eva, t):
    """dSDF/dt at fixed world points: one forward-mode derivative in t."""
    t = torch.as_tensor(t, dtype=p_eva.dtype, device=p_eva.device)
    _, dot = torch.func.jvp(
        lambda tt: sdf_at_time(shape, traj, params, p_eva, tt), (t,),
        (torch.ones_like(t),))
    return dot


def kernel_ok(shape, coarse_n: int) -> bool:
    """Whether a sweep goes to the kernels (K1/K2 for a shape with a device
    SDF, K3 for a baked field): their coarse scan takes coarse_n in groups
    of 8, and a shape built by hand without a ``ShapeSpec`` has no device
    SDF to compile.  Otherwise the sweep runs the non-fused path."""
    return coarse_n % 8 == 0 and (shape.grid is not None
                                  or shape.spec is not None)


def _grid_times(total, n: int):
    """n uniform times over [0, total] (``total`` (...,) → (..., n)), as
    ``jnp.linspace(0, total, n)`` rounds them: total · (i / (n − 1))."""
    frac = torch.arange(n, dtype=total.dtype, device=total.device) / (n - 1)
    return total[..., None] * frac


def _sdf_c(shape, traj, params, pw, t):
    """``sdf_at_time_c`` at times t (..., k, P) or (..., P) against points pw
    broadcasting to t; a batched trajectory takes its rows flat, (B, M)."""
    if not traj.batched:
        return sdf_at_time_c(shape, traj, params, pw, t)
    B = t.shape[0]
    flat = tuple(torch.broadcast_to(c, t.shape).reshape(B, -1) for c in pw)
    return sdf_at_time_c(shape, traj, params, flat,
                         t.reshape(B, -1)).reshape(t.shape)


def _coarse_seed(shape, traj, params, p_eva, ts):
    """First argmin over the coarse times ts (..., T) of the SDF table
    (..., T, P) built from the shared poses → t0 (..., P)."""
    xs, Rs = traj_states(traj, params, ts)
    pw = tuple(p_eva[..., i].unsqueeze(-2) for i in range(3))
    x3 = tuple(xs[..., i, None] for i in range(3))
    R = tuple(Rs[..., i, j, None] for i in range(3) for j in range(3))
    table = shape.sdf3_fn()(*rel_components(pw, x3, R))
    j = torch.argmin(table, dim=-2)
    return torch.gather(ts, -1, j) if ts.dim() > 1 else ts[j]


def _plateau_argmin0(d, cand, tie_eps: float = 1e-4):
    """Centre of the connected near-minimum run around the first argmin,
    over the candidate axis (-2) of (..., k, P) arrays: equals the argmin for
    a strict minimum, and sits inside a plateau (a point inside the body),
    where the frozen-t* gradient needs it.  The tie band is relative to the
    minimum's magnitude, floored at tie_eps."""
    dmin = d.min(dim=-2, keepdim=True).values
    eps = tie_eps * torch.clamp(dmin.abs(), min=1.0)
    tie = d <= dmin + eps
    j = torch.argmin(d, dim=-2, keepdim=True)
    idx = torch.arange(d.shape[-2], device=d.device)[:, None]
    conn_r = torch.cumprod((tie | (idx <= j)).to(d.dtype), dim=-2) > 0
    conn_l = torch.flip(torch.cumprod(
        torch.flip((tie | (idx >= j)).to(d.dtype), [-2]), dim=-2), [-2]) > 0
    conn = torch.where(idx >= j, conn_r, conn_l)
    return (torch.where(conn, cand, torch.zeros_like(cand)).sum(dim=-2)
            / conn.sum(dim=-2))


def _zoom(shape, traj, params, p_eva, t0, w0, rounds: int, k: int = 8):
    """Fixed-round interval zoom around seeds t0 (..., P): each round
    evaluates k candidates in [t − w, t + w] (clipped to the trajectory),
    re-centres on the plateau-centred argmin and shrinks w by 2/(k − 1).
    → (t*, SDF at t*), the value differentiable in the trajectory and the
    points at the frozen t*."""
    total = traj.total_duration.detach()[..., None].to(t0.dtype)
    frac = torch.arange(k, dtype=t0.dtype, device=t0.device) / (k - 1)
    offs = (-(1.0 - frac) + frac)[:, None]       # jnp.linspace(-1, 1, k)
    pw = tuple(p_eva[..., i] for i in range(3))
    pw_k = tuple(c.unsqueeze(-2) for c in pw)
    tr = traj.detach()
    with torch.no_grad():
        t = t0.detach()
        w = torch.broadcast_to(torch.as_tensor(w0, dtype=t.dtype,
                                               device=t.device), t.shape)
        for _ in range(rounds):
            cand = torch.minimum(torch.maximum(
                t.unsqueeze(-2) + w.unsqueeze(-2) * offs,
                torch.zeros_like(total[..., None])), total[..., None])
            d = _sdf_c(shape, tr, params, pw_k, cand)
            t = _plateau_argmin0(d, cand)
            w = w * (2.0 / (k - 1))
    return t, _sdf_c(shape, traj, params, pw, t)


def _sweep_xla(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
               warm_window):
    """The non-fused sweep: the coarse seed, then the warm zoom (from t_warm
    in ±warm_window) and the cold zoom (from the coarse seed in ± one coarse
    step), one after the other; the deeper minimum wins (dA <= dB).  With
    t_warm None it is the cold sweep: the cold zoom alone."""
    global XLA_CALLS
    XLA_CALLS += 1
    with torch.no_grad():
        total = traj.total_duration.detach().to(p_eva.dtype)
        ts = _grid_times(total, coarse_n)
        t0 = _coarse_seed(shape, traj.detach(), params, p_eva.detach(), ts)
    w0 = (total / (coarse_n - 1))[..., None]
    tB, dB = _zoom(shape, traj, params, p_eva, t0, w0, refine_rounds)
    if t_warm is None:
        t_star, sdf_star = tB, dB
    else:
        tw = torch.minimum(torch.maximum(t_warm.detach(),
                                         torch.zeros_like(t_warm)),
                           total[..., None])
        tA, dA = _zoom(shape, traj, params, p_eva, tw, warm_window,
                       refine_rounds)
        use_a = dA.detach() <= dB.detach()
        t_star = torch.where(use_a, tA, tB)
        sdf_star = torch.where(use_a, dA, dB)
    return sdf_star, t_star, _grad_prel(shape, traj, params, p_eva, t_star)


def kernel_args(shape, traj, params, p_eva, t_warm, coarse_n):
    """The warm sweep's first step: the kernel's arguments from a
    trajectory, with no grad → (points, t_warm, [pose table,] starts,
    durations, coefficients), contiguous, in float32 on the card (the
    working dtype on the CPU).  The pose table (the poses at the coarse
    times, for K1/K2) is left out for a baked field (K3)."""
    kdtype = torch.float32 if p_eva.is_cuda else p_eva.dtype
    with torch.no_grad():
        durs = traj.durations.detach()
        starts = torch.cumsum(durs, -1) - durs
        if shape.grid is not None:
            args = (p_eva.detach(), t_warm.detach(), starts, durs,
                    traj.coeffs.detach())
        else:
            ts = torch.linspace(0.0, 1.0, coarse_n, dtype=p_eva.dtype,
                                device=p_eva.device) \
                * traj.total_duration[..., None]
            xs, Rs = traj_states(traj.detach(), params, ts)
            pose = torch.cat([xs, Rs.flatten(-2)], dim=-1)
            args = (p_eva.detach(), t_warm.detach(), pose, starts, durs,
                    traj.coeffs.detach())
        return tuple(a.to(kdtype).contiguous() for a in args)


def launch(shape, params, args, coarse_n, refine_rounds, warm_window,
           dtype):
    """The warm sweep's second step: one launch of K1/K2 (a shape with a
    device SDF) or K3 (a baked field) on ``kernel_args``' arguments, the
    entry point looked up on its module at each call → (t*, d*, g*) in
    ``dtype``, all constants of the gradient."""
    batched = args[0].dim() == 3
    if shape.grid is not None:
        kernel = (grid_zoom.grid_sweep_warm_fused_batched if batched
                  else grid_zoom.grid_sweep_warm_fused)
        body = shape.grid
    else:
        kernel = (fused_zoom.sweep_warm_fused_batched if batched
                  else fused_zoom.sweep_warm_fused)
        body = shape
    with torch.no_grad():
        out = kernel(body, params, *args, coarse_n=coarse_n,
                     rounds=refine_rounds, warm_window=warm_window)
    return tuple(a.to(dtype) for a in out)


def sweep_value(shape, traj, params, p_eva, kout):
    """The warm sweep's last step: the differentiable swept SDF at the
    kernel's constant (t*, d*, g*), the trajectory's state at t* from
    ``pieces.pvaj_at`` (K5 on the card).  K1/K2: the body SDF re-evaluated
    at t*.  K3: the linearisation of the body SDF at the epilogue point,
    sdf(p_rel) ≈ d* + g*·(p_rel − p_rel*), with p_rel(traj, p, t*) the
    differentiable pose chain — how the reference consumes (sdf_value,
    gradp_rel) pairs (back_end_optimizer.hpp:619-627).  Its value equals
    d*; the voxel field is not read outside the kernel."""
    t_star, d0, g0 = kout
    pw = (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2])
    rx, ry, rz = rel_at_state(pw, pieces.pvaj_at(traj, t_star), params)
    if shape.grid is None:
        return shape.sdf3_fn()(rx, ry, rz)
    return (d0 + g0[..., 0] * (rx - rx.detach())
            + g0[..., 1] * (ry - ry.detach())
            + g0[..., 2] * (rz - rz.detach()))


def _kernel(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
            warm_window):
    """One launch of K1/K2 (p_eva (P, 3) or (B, P, 3), a pose table each)
    or K3 (a baked field) → (t*, d*, g*) in the working dtype, all constants
    of the graph.  On the card the kernel runs in float32, as the Pallas
    kernel does."""
    return launch(shape, params,
                  kernel_args(shape, traj, params, p_eva, t_warm, coarse_n),
                  coarse_n, refine_rounds, warm_window, p_eva.dtype)


def _sweep_fused(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
                 warm_window):
    """One kernel launch + the differentiable value at its t*
    (:func:`sweep_value`)."""
    kout = _kernel(shape, traj, params, p_eva, t_warm, coarse_n,
                   refine_rounds, warm_window)
    return sweep_value(shape, traj, params, p_eva, kout), kout[0], kout[2]


def _grad_prel(shape, traj, params, p_eva, t_star):
    """∂SDF/∂p_rel at the argmin pose (ref getGradPrelAtTimeStamp,
    sw_manager.hpp:566-572), by autograd of the body SDF."""
    with torch.no_grad():
        prel = rel_at_state(
            (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2]),
            pvaj_components(traj.detach(), t_star, n_orders=3)[:3], params)
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
    if not kernel_ok(shape, coarse_n):
        return _sweep_xla(shape, traj, params, p_eva, None, coarse_n,
                          refine_rounds, 0.3)
    t_warm = torch.zeros_like(p_eva[..., 0])
    if shape.grid is not None:
        t_star, _, _ = _kernel(shape, traj, params, p_eva, t_warm, coarse_n,
                               refine_rounds, 0.3)
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
    sweep = _sweep_fused if kernel_ok(shape, coarse_n) else _sweep_xla
    return sweep(shape, traj, params, p_eva, t_warm, coarse_n, refine_rounds,
                 warm_window)
