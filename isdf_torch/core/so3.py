"""Small SO(3)/quaternion helpers, batched (counterpart of
``isdf_tpu/core/so3.py``)."""

from __future__ import annotations

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def hat(w: torch.Tensor) -> torch.Tensor:
    """Vector (..., 3) → skew matrix (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            zeros, -w[..., 2], w[..., 1],
            w[..., 2], zeros, -w[..., 0],
            -w[..., 1], w[..., 0], zeros,
        ],
        dim=-1,
    ).reshape(w.shape[:-1] + (3, 3))


def exp_rotvec(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) → rotation matrix (Rodrigues), autograd-safe
    at ‖v‖ → 0 (series-expanded coefficients)."""
    th2 = torch.sum(v * v, dim=-1)
    th = torch.sqrt(th2 + 1e-30)
    small = th < 1e-4
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    K = hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_rot(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → rotation vector (..., 3); valid away from the
    π-rotation branch cut."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_th = torch.clamp(0.5 * (tr - 1.0), -1.0 + 1e-7, 1.0 - 1e-7)
    th = torch.arccos(cos_th)
    w = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    scale = torch.where(th < 1e-4, 1.0 + th * th / 6.0, th / torch.sin(th))
    return w * scale[..., None]


def rpy_to_rot(roll, pitch, yaw) -> torch.Tensor:
    """ZYX euler (applied as Rz(yaw)·Ry(pitch)·Rx(roll)) → rotation matrix."""
    roll, pitch, yaw = torch.broadcast_tensors(
        *(torch.as_tensor(a) for a in (roll, pitch, yaw)))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return r.reshape(roll.shape + (3, 3))
