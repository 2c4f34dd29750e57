"""Geometric SE(3)/SO(3) tracking controller (counterpart of
``isdf_tpu/sim/so3_control.py``).

Re-derivation of the reference's ``so3_control`` nodelet
(ref src/uav_simulator/so3_control/src/SO3Control.cpp:50-107): desired force
f = m·g·e₃ + Kx(p_d − p) + Kv(v_d − v) + m·a_d with a tilt-angle safety
limit, desired attitude from (f, ψ), and an SO(3) attitude P-D loop on
(e_R, e_ω) producing body moments — the standard Lee geometric controller.
Tensors in, tensors out, on the state's device and in its dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SO3ControlGains(NamedTuple):
    kx: tuple = (5.7, 5.7, 6.2)
    kv: tuple = (3.4, 3.4, 4.0)
    kR: tuple = (1.5, 1.5, 1.0)
    kOm: tuple = (0.13, 0.13, 0.1)
    max_tilt_cos: float = 0.25   # limit on e3·f̂ (ref cos limit)


def _vee(M):
    return torch.stack([M[2, 1], M[0, 2], M[1, 0]])


def so3_control(
    pos, vel, R, omega,
    des_pos, des_vel, des_acc, des_yaw,
    mass: float, g: float, gains: SO3ControlGains = SO3ControlGains(),
    inertia=(2.64e-3, 2.64e-3, 4.96e-3),
):
    """Returns (thrust scalar, body moments (3,))."""
    kw = dict(dtype=pos.dtype, device=pos.device)
    t = lambda a: torch.as_tensor(a, **kw)  # noqa: E731
    e3 = t([0.0, 0.0, 1.0])
    force = (
        mass * g * e3
        + t(gains.kx) * (t(des_pos) - pos)
        + t(gains.kv) * (t(des_vel) - vel)
        + mass * t(des_acc)
    )
    # tilt limiting (SO3Control.cpp:79-88): shrink the horizontal component
    # until the force direction stays within the cone around e3
    fnorm = torch.linalg.norm(force) + 1e-9
    cos_tilt = force[2] / fnorm
    f_h = force - force[2] * e3
    scale = torch.where(
        cos_tilt < gains.max_tilt_cos,
        torch.abs(force[2]) / (torch.linalg.norm(f_h) + 1e-9)
        * math.sqrt(1.0 / gains.max_tilt_cos ** 2 - 1.0),
        t(1.0),
    )
    force = f_h * torch.minimum(scale, t(1.0)) + force[2] * e3

    b3c = force / (torch.linalg.norm(force) + 1e-9)
    yaw = t(des_yaw)
    b1d = torch.stack([torch.cos(yaw), torch.sin(yaw), t(0.0)])
    b2c = torch.linalg.cross(b3c, b1d)
    b2c = b2c / (torch.linalg.norm(b2c) + 1e-9)
    b1c = torch.linalg.cross(b2c, b3c)
    Rc = torch.stack([b1c, b2c, b3c], dim=1)

    thrust = torch.dot(force, R @ e3)

    eR = 0.5 * _vee(Rc.T @ R - R.T @ Rc)
    eOm = omega  # desired body rate ≈ 0 for position tracking
    J = torch.diag(t(inertia))
    M = (
        -t(gains.kR) * eR
        - t(gains.kOm) * eOm
        + torch.linalg.cross(omega, J @ omega)
    )
    return thrust, M
