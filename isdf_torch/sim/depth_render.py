"""Depth-camera rendering from the occupancy map (counterpart of
``isdf_tpu/sim/depth_render.py``; the reference's ``local_sensing``,
src/uav_simulator/local_sensing/src/depth_render.cu:1-196 + the pointcloud
raycast sensor).

Sphere tracing over the map ESDF: every pixel marches its ray by the signed
distance at its current sample, a fixed number of rounds, all pixels in
lockstep as one (H·W,)-batched elementwise program.  In JAX this is XLA,
not a Pallas kernel; here it is plain PyTorch on the map's device.  The
ESDF already exists for planning (world/gridmap.py), so rendering costs no
extra precomputation.

Also provides the raycast point-cloud sensor (depth → camera-frame points →
world-frame point cloud), matching the reference's pcl_render_node output.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CameraIntrinsics(NamedTuple):
    """Pinhole model (ref local_sensing depth_render fx/fy/cx/cy params)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_fov(cls, width: int, height: int, fov_x_deg: float = 90.0):
        fx = width / (2.0 * math.tan(math.radians(fov_x_deg) / 2.0))
        return cls(width, height, float(fx), float(fx),
                   width / 2.0, height / 2.0)


def _ray_dirs(cam: CameraIntrinsics, dtype, device) -> torch.Tensor:
    """Unit ray directions in the camera frame (z forward, x right, y down),
    shape (H·W, 3)."""
    u = torch.arange(cam.width, dtype=dtype, device=device)
    v = torch.arange(cam.height, dtype=dtype, device=device)
    uu, vv = torch.meshgrid(u, v, indexing="xy")     # (H, W)
    x = (uu - cam.cx) / cam.fx
    y = (vv - cam.cy) / cam.fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1).reshape(-1, 3)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _pose(gridmap, position, rotation):
    esdf = gridmap.esdf
    kw = dict(dtype=esdf.dtype, device=esdf.device)
    return torch.as_tensor(position, **kw), torch.as_tensor(rotation, **kw)


@torch.no_grad()
def render_depth(gridmap, cam: CameraIntrinsics, position, rotation,
                 max_depth: float = 20.0, max_steps: int = 96,
                 hit_eps: float = 1e-2) -> torch.Tensor:
    """Depth image (H, W) by sphere tracing the map ESDF, on the map's
    device and in the ESDF's dtype.

    position (3,) world; rotation (3, 3) camera-to-world.  Pixels that never
    hit return max_depth.  Requires ``gridmap.esdf`` (``with_esdf()``).
    """
    if gridmap.esdf is None:
        raise ValueError("call gridmap.with_esdf() first")
    pos, R = _pose(gridmap, position, rotation)
    dirs = _ray_dirs(cam, pos.dtype, pos.device) @ R.T     # (P, 3) world

    t = torch.zeros(dirs.shape[0], dtype=pos.dtype, device=pos.device)
    for _ in range(max_steps):
        p = pos[None, :] + t[:, None] * dirs
        d = gridmap.sdf_value(p)                            # (P,)
        # stop advancing once hit (d small) or past the horizon
        adv = torch.where(d > hit_eps, d, torch.zeros_like(d))
        t = torch.clamp(t + adv, max=max_depth)
    p = pos[None, :] + t[:, None] * dirs
    # a hit must land INSIDE the grid: outside, the trilinear ESDF clamps to
    # boundary values, which would report phantom surfaces at the map edge
    lo = gridmap.origin.to(pos.dtype)
    hi = lo + torch.as_tensor(gridmap.occ.shape, dtype=pos.dtype,
                              device=pos.device) * gridmap.resolution
    inside = torch.all((p >= lo) & (p <= hi), dim=-1)
    hit = (gridmap.sdf_value(p) <= 2.0 * hit_eps) & inside
    depth = torch.where(hit, t, torch.full_like(t, max_depth))
    return depth.reshape(cam.height, cam.width)


@torch.no_grad()
def render_pointcloud(gridmap, cam: CameraIntrinsics, position, rotation,
                      max_depth: float = 20.0, max_steps: int = 96):
    """Raycast point-cloud sensor: world-frame hit points + validity mask
    ((H·W, 3), (H·W,) bool) — the pcl_render_node output equivalent."""
    depth = render_depth(gridmap, cam, position, rotation, max_depth,
                         max_steps).reshape(-1)
    pos, R = _pose(gridmap, position, rotation)
    dirs = _ray_dirs(cam, pos.dtype, pos.device) @ R.T
    pts = pos[None, :] + depth[:, None] * dirs
    return pts, depth < max_depth
