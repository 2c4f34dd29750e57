"""Pose-indexed collision kernels and whole-map pose feasibility
(counterpart of ``isdf_tpu/search/pose_kernels.py``).

For each (roll, pitch) on the grid [−max..max] step ang_res, a K³ boolean
voxelization of {SDF(R_rpᵀ p) ≤ safemargin}, R_rp = Rx(roll)·Ry(pitch).  The
full feasibility volume feasible[R, P, X, Y, Z] = (occupancy ⊛ kernel_rp) == 0
is one batched 3-D convolution; A* then does O(1) lookups.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from isdf_torch.core.so3 import rpy_to_rot
from isdf_torch.device import resolve_device


@dataclass(frozen=True)
class PoseKernels:
    kernels: torch.Tensor      # (R, P, K, K, K) bool — True = body occupies
    rolls: torch.Tensor        # (R,) radians
    pitches: torch.Tensor      # (P,) radians


def pose_grid(conf):
    """Degree grids matching the reference's loop (Shape.hpp:423-427)."""
    rolls = np.arange(-conf.kernel_max_roll, conf.kernel_max_roll + 1e-9,
                      conf.kernel_ang_res)
    pitches = np.arange(-conf.kernel_max_pitch, conf.kernel_max_pitch + 1e-9,
                        conf.kernel_ang_res)
    return rolls, pitches


@torch.no_grad()
def _voxelize(shape, rolls_rad, pitches_rad, kernel_size: int, res: float,
              safemargin: float):
    K = kernel_size
    dtype, dev = rolls_rad.dtype, rolls_rad.device
    ax = (torch.arange(K, dtype=dtype, device=dev) - 0.5 * (K - 1)) * res
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    Rr = rpy_to_rot(rolls_rad, zero, zero)                  # (R, 3, 3)
    Rp = rpy_to_rot(zero, pitches_rad, zero)                # (P, 3, 3)
    R = Rr[:, None] @ Rp[None, :]                           # (R, P, 3, 3)
    # body occupies a voxel iff SDF(Rᵀ p) ≤ safemargin
    p_local = torch.einsum("rpji,xyzj->rpxyzi", R, g)
    return shape.sdf(p_local) <= safemargin


def build_pose_kernels(shape, conf, device=None,
                       dtype=torch.float64) -> PoseKernels:
    """Voxelized body at every (roll, pitch), on ``device`` (default: the
    CUDA card).  float64 by default: a one-time precompute, and the
    ≤ safemargin test then agrees with the reference's voxelization at the
    boundary."""
    # a kernel smaller than the body silently truncates it, making the A*
    # feasibility volume optimistic
    half = 0.5 * (conf.kernel_size - 1) * conf.occupancy_resolution
    b = getattr(shape, "bounds", None)
    if b is not None and max(b) > half + 0.5 * conf.occupancy_resolution:
        warnings.warn(
            f"pose kernel half-size {half:.2f} m < shape bound {max(b):.2f} m"
            " — the collision kernel truncates the body; increase"
            " kernel_size or occupancy_resolution",
            stacklevel=2,
        )
    device = resolve_device(device)
    rolls_deg, pitches_deg = pose_grid(conf)
    rolls = torch.as_tensor(np.radians(rolls_deg), dtype=dtype, device=device)
    pitches = torch.as_tensor(np.radians(pitches_deg), dtype=dtype,
                              device=device)
    safemargin = max(conf.front_end_safeh, conf.occupancy_resolution / 2)
    kern = _voxelize(shape, rolls, pitches, conf.kernel_size,
                     conf.occupancy_resolution, safemargin)
    return PoseKernels(kernels=kern, rolls=rolls, pitches=pitches)


@torch.no_grad()
def pose_feasibility(occ: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """feasible[R, P, X, Y, Z]: the shape kernel at pose (r, p) centred on
    voxel (x, y, z) overlaps no occupied voxel.  One conv3d with R·P output
    channels and "same" padding, so out-of-map voxels count as free (the
    reference zero-pads its bit map).  The inputs are 0/1 and the counts are
    integers below 2^24, exact in float32 accumulation whether or not cuDNN
    rounds its inputs to TF32: TF32 is allowed here, explicitly."""
    R, P, K = kernels.shape[:3]
    occf = occ.to(torch.float32)[None, None]                # (1, 1, X, Y, Z)
    kf = kernels.to(torch.float32).reshape(R * P, 1, K, K, K)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        out = F.conv3d(occf, kf, padding="same")[0]         # (RP, X, Y, Z)
    return (out < 0.5).reshape(R, P, *occ.shape)


def nearest_feasible_pose(feas_rp: np.ndarray, father: tuple):
    """checkKernelValue's pose choice (sw_manager.hpp:915-942): zero pose
    first, else the BFS-nearest feasible pose from the father.
    feas_rp: (R, P) bool for one voxel.  Returns (i, j) or None."""
    Rn, Pn = feas_rp.shape
    zi, zj = (Rn - 1) // 2, (Pn - 1) // 2
    if feas_rp[zi, zj]:
        return zi, zj
    if not feas_rp.any():
        return None
    ii, jj = np.meshgrid(np.arange(Rn), np.arange(Pn), indexing="ij")
    d = np.abs(ii - father[0]) + np.abs(jj - father[1])
    d = np.where(feas_rp, d, 1 << 20)
    k = int(np.argmin(d))
    return k // Pn, k % Pn
