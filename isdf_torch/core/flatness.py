"""Quadrotor differential-flatness map with drag (counterpart of
``isdf_tpu/core/flatness.py``).

Drag-augmented net force zu = a + (dh/m)(1 + cp‖v‖_ε) v + g e₃ defines the
body z-axis z = zu/‖zu‖; the tilt-only quaternion is the minimal rotation
taking e₃ → z; ω follows from ż projected through the normalization
Jacobian.  Gradients come from autograd.  All functions broadcast over
leading batch dimensions.  (The planar SE(2) pose map waits for the planar
slice of the port.)
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


def pose_of(pos, vel, acc, jer, p: FlatParams):
    """(p/v/a/j) → (position ℝ³, attitude R)."""
    return pos, quat_to_rot(tilt_quat(vel, acc, p))


def rates_of(pos, vel, acc, jer, p: FlatParams):
    """(quat, ω) for the dynamic-feasibility penalties."""
    return forward(vel, acc, jer, p)
