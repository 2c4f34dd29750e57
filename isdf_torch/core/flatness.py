"""Quadrotor differential-flatness map with drag (counterpart of
``isdf_tpu/core/flatness.py``).

Drag-augmented net force zu = a + (dh/m)(1 + cp‖v‖_ε) v + g e₃ defines the
body z-axis z = zu/‖zu‖; the tilt-only quaternion is the minimal rotation
taking e₃ → z; ω follows from ż projected through the normalization
Jacobian.  Gradients come from autograd.  All functions broadcast over
leading batch dimensions.

The second pose map, :class:`PlanarPose`, is SE(2): the trajectory's third
coordinate is the yaw ψ and the pose is ((x, y, z_ref), Rz(ψ)).  ``pose_of``
and ``rates_of`` take either map.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from isdf_torch.core.so3 import quat_to_rot


@dataclass(frozen=True)
class FlatParams:
    mass: float = 0.61
    grav: float = 9.8
    dh: float = 0.10          # horizontal drag coeff
    dv: float = 0.10          # vertical drag coeff
    cp: float = 0.01          # parasitic drag coeff
    veps: float = 1.0e-4      # speed smoothing

    @classmethod
    def from_config(cls, conf):
        return cls(
            mass=conf.vehicleMass,
            grav=conf.gravAcc,
            dh=conf.horizDrag,
            dv=conf.vertDrag,
            cp=conf.parasDrag,
            veps=conf.speedEps,
        )


def _zu(vel, acc, p: FlatParams):
    """Drag-augmented specific force (un-normalized body z)."""
    cp_term = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True) + p.veps)
    w_term = 1.0 + p.cp * cp_term
    w = w_term * vel
    g3 = torch.zeros_like(vel)
    g3[..., 2] = p.grav
    zu = acc + (p.dh / p.mass) * w + g3
    return zu, w, w_term, cp_term


def _tilt(z):
    tilt_den = torch.sqrt(2.0 * (1.0 + z[..., 2]))
    return torch.stack(
        [
            0.5 * tilt_den,
            -z[..., 1] / tilt_den,
            z[..., 0] / tilt_den,
            torch.zeros_like(tilt_den),
        ],
        dim=-1,
    )


def tilt_quat(vel, acc, p: FlatParams):
    """Tilt-only quaternion (w,x,y,z) with zero yaw."""
    zu, _, _, _ = _zu(vel, acc, p)
    z = zu / torch.linalg.norm(zu, dim=-1, keepdim=True)
    return _tilt(z)


def forward(vel, acc, jer, p: FlatParams):
    """(v, a, j) → (quat (..., 4), ω (..., 3)) with zero yaw."""
    zu, w, w_term, cp_term = _zu(vel, acc, p)
    zu_norm = torch.sqrt(torch.sum(zu * zu, dim=-1, keepdim=True))
    z = zu / zu_norm
    quat = _tilt(z)

    v_dot_a = torch.sum(vel * acc, dim=-1, keepdim=True)
    dw_term = p.cp * v_dot_a / cp_term
    dw = w_term * acc + dw_term * vel
    dzu = jer + (p.dh / p.mass) * dw
    eye = torch.eye(3, dtype=zu.dtype, device=zu.device)
    ng = (eye - z[..., :, None] * z[..., None, :]) / zu_norm[..., None]
    dz = torch.einsum("...ij,...j->...i", ng, dzu)

    omg_den = z[..., 2] + 1.0
    omg_term = dz[..., 2] / omg_den
    omg = torch.stack(
        [
            -dz[..., 1] + z[..., 1] * omg_term,
            dz[..., 0] - z[..., 0] * omg_term,
            (z[..., 1] * dz[..., 0] - z[..., 0] * dz[..., 1]) / omg_den,
        ],
        dim=-1,
    )
    return quat, omg


@dataclass(frozen=True)
class PlanarPose:
    """SE(2) pose map of the planar planner: MINCO optimizes (x, y, ψ)
    jointly and the robot pose is ((x, y, z_ref), Rz(ψ)).  Passing it where
    a pose map is expected switches the sweep, the penalties and the
    kernels to SE(2)."""

    z_ref: float = 0.0


POSE_MAPS = (FlatParams, PlanarPose)


def pose_of(pos, vel, acc, jer, p):
    """(p/v/a/j) → (position ℝ³, attitude R) under either pose map."""
    if isinstance(p, PlanarPose):
        yaw = pos[..., 2]
        c, s = torch.cos(yaw), torch.sin(yaw)
        zeros = torch.zeros_like(c)
        ones = torch.ones_like(c)
        R = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones],
                        dim=-1).reshape(yaw.shape + (3, 3))
        pos3 = torch.stack([pos[..., 0], pos[..., 1],
                            torch.full_like(c, p.z_ref)], dim=-1)
        return pos3, R
    return pos, quat_to_rot(tilt_quat(vel, acc, p))


def rates_of(pos, vel, acc, jer, p):
    """(quat, ω) for the dynamic-feasibility penalties under either map.
    Planar: the yaw quaternion (no tilt) and ω = (0, 0, ψ̇)."""
    if isinstance(p, PlanarPose):
        half = 0.5 * pos[..., 2]
        zeros = torch.zeros_like(half)
        quat = torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)],
                           dim=-1)
        omg = torch.stack([zeros, zeros, vel[..., 2]], dim=-1)
        return quat, omg
    return forward(vel, acc, jer, p)
