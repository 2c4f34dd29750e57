"""SO(3) quadrotor rigid-body dynamics simulator (counterpart of
``isdf_tpu/sim/quadrotor.py``).

Re-derivation of the reference's ``so3_quadrotor_simulator``
(ref src/uav_simulator/so3_quadrotor_simulator/src/dynamics/Quadrotor.cpp:
state = (pos, vel, R, ω, motor rpm); per-motor first-order lag with time
constant 1/30 s; thrust = k_f Σ rpm², X-configuration moments, external
drag), integrated by RK4.  JAX's ``rollout`` is a ``lax.scan``; here it is
a plain loop, since each step depends on the last.  States are tensors on
the device and in the dtype of the state they start from
(:meth:`QuadState.hover`: float64 on ``device``, None = the CUDA card).

Parameter defaults follow Quadrotor.cpp:20-35.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from isdf_torch.device import resolve_device


class QuadrotorParams(NamedTuple):
    mass: float = 0.98
    g: float = 9.81
    arm_length: float = 0.26
    kf: float = 8.98132e-9
    km: float = 0.07 * (3 * 0.099) * 8.98132e-9   # (Cq/Ct)·D·kf, prop r=0.099
    motor_tau: float = 1.0 / 30.0
    inertia: tuple = (2.64e-3, 2.64e-3, 4.96e-3)  # Quadrotor.cpp J diag
    drag: float = 0.10                            # linear air drag coeff
    motor_rpm_min: float = 1200.0
    motor_rpm_max: float = 35000.0


class QuadState(NamedTuple):
    pos: torch.Tensor        # (3,)
    vel: torch.Tensor        # (3,)
    R: torch.Tensor          # (3, 3)
    omega: torch.Tensor      # (3,) body rates
    motor_rpm: torch.Tensor  # (4,)

    @staticmethod
    def hover(p: QuadrotorParams, pos=None, device=None):
        kw = dict(dtype=torch.float64, device=resolve_device(device))
        pos = (torch.zeros(3, **kw) if pos is None
               else torch.as_tensor(pos, **kw))
        rpm = math.sqrt(p.mass * p.g / (4 * p.kf))
        return QuadState(pos=pos, vel=torch.zeros(3, **kw),
                         R=torch.eye(3, **kw), omega=torch.zeros(3, **kw),
                         motor_rpm=torch.full((4,), rpm, **kw))


def _e3(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)


def _deriv(s: QuadState, rpm_cmd, p: QuadrotorParams) -> QuadState:
    rpm_sq = s.motor_rpm ** 2
    thrust = p.kf * torch.sum(rpm_sq)
    # X-configuration moments (Quadrotor.cpp:155-158)
    mx = p.kf * (rpm_sq[2] - rpm_sq[3]) * p.arm_length
    my = p.kf * (rpm_sq[1] - rpm_sq[0]) * p.arm_length
    mz = p.km * (rpm_sq[0] + rpm_sq[1] - rpm_sq[2] - rpm_sq[3])
    M = torch.stack([mx, my, mz])

    e3 = _e3(s.vel)
    force = thrust * s.R @ e3 - p.mass * p.g * e3 - p.drag * s.vel
    acc = force / p.mass

    J = torch.diag(torch.as_tensor(p.inertia, dtype=s.vel.dtype,
                                   device=s.vel.device))
    omega_dot = torch.linalg.solve(
        J, M - torch.linalg.cross(s.omega, J @ s.omega))

    wx, wy, wz = s.omega
    zero = torch.zeros_like(wx)
    omega_hat = torch.stack([torch.stack([zero, -wz, wy]),
                             torch.stack([wz, zero, -wx]),
                             torch.stack([-wy, wx, zero])])
    R_dot = s.R @ omega_hat

    rpm_dot = (rpm_cmd - s.motor_rpm) / p.motor_tau
    return QuadState(s.vel, acc, R_dot, omega_dot, rpm_dot)


def _axpy(s: QuadState, d: QuadState, h) -> QuadState:
    return QuadState(*(a + h * b for a, b in zip(s, d)))


def step(s: QuadState, rpm_cmd, p: QuadrotorParams,
         dt: float = 0.01) -> QuadState:
    """One RK4 step + rotation re-orthonormalization + motor limits."""
    rpm_cmd = torch.clamp(torch.as_tensor(rpm_cmd, dtype=s.vel.dtype,
                                          device=s.vel.device),
                          p.motor_rpm_min, p.motor_rpm_max)
    k1 = _deriv(s, rpm_cmd, p)
    k2 = _deriv(_axpy(s, k1, dt / 2), rpm_cmd, p)
    k3 = _deriv(_axpy(s, k2, dt / 2), rpm_cmd, p)
    k4 = _deriv(_axpy(s, k3, dt), rpm_cmd, p)
    out = QuadState(*(
        a + dt / 6 * (b1 + 2 * b2 + 2 * b3 + b4)
        for a, b1, b2, b3, b4 in zip(s, k1, k2, k3, k4)))
    # project R back to SO(3) (the integration drifts; the reference
    # renormalizes too)
    u, _, vt = torch.linalg.svd(out.R)
    R = u @ vt
    R = R * torch.sign(torch.linalg.det(R))
    return out._replace(
        R=R, motor_rpm=torch.clamp(out.motor_rpm, p.motor_rpm_min,
                                   p.motor_rpm_max))


def rollout(s0: QuadState, rpm_cmds, p: QuadrotorParams, dt: float = 0.01):
    """Integrate a whole command sequence (T, 4) → (final state, the
    states after every step, each field stacked along a leading T)."""
    s, states = s0, []
    for cmd in rpm_cmds:
        s = step(s, cmd, p, dt)
        states.append(s)
    return s, QuadState(*(torch.stack(f) for f in zip(*states)))


def force_moments_to_rpm(thrust, M, p: QuadrotorParams):
    """Invert the mixer: desired total thrust + moments → motor rpm commands
    (the so3_control → simulator interface)."""
    L, kf, km = p.arm_length, p.kf, p.km
    # thrust = kf Σ w², mx = kf L (w2²−w3²), my = kf L (w1²−w0²),
    # mz = km (w0²+w1²−w2²−w3²)
    A = torch.tensor(
        [
            [kf, kf, kf, kf],
            [0.0, 0.0, kf * L, -kf * L],
            [-kf * L, kf * L, 0.0, 0.0],
            [km, km, -km, -km],
        ], dtype=M.dtype, device=M.device)
    b = torch.cat([torch.atleast_1d(torch.as_tensor(
        thrust, dtype=M.dtype, device=M.device)), M])
    w_sq = torch.linalg.solve(A, b)
    return torch.sqrt(torch.clamp(w_sq, p.motor_rpm_min ** 2,
                                  p.motor_rpm_max ** 2))
