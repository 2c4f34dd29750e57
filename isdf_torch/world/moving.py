"""Moving obstacles and their predicted motion — the ``moving_obstacles``
node's counterpart (counterpart of ``isdf_tpu/world/moving.py``; ref
src/common/moving_obstacles/src/moving_obstacles.cpp).

The reference animates planar obstacles with decayed-velocity dynamics
(dyn_update: vel += a·dt, vel *= 0.9, ‖vel‖ ≤ MAX_VEL, cpp:44-55), predicts
their motion a fixed horizon ahead by replaying the same dynamics (predict,
cpp:75-86) and fits a MINCO minimum-jerk trajectory through the predicted
waypoints (predict_traj, cpp:92-117).  The dynamics are host numpy (they
generate the scene, they are not the compute path); the predictor reuses
the engine's MINCO solve, so a predicted obstacle is a ``PolyTraj``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.device import resolve_device


MAX_VEL = 3.0          # ref moving_obstacles.cpp MAX_VEL
VEL_DECAY = 0.9        # ref cpp:48 "gradually stop like a real obstacle"
PRED_TIME = 5.0        # ref cpp:95
SEG_NUM = 10           # ref cpp:96


def _dyn_update(dt: float, acc: float, yaw_rate: float,
                yaw: float, pos: np.ndarray, vel: np.ndarray):
    """One dynamics step (ref dyn_update cpp:44-55)."""
    yaw = yaw + yaw_rate * dt
    acc_vec = acc * np.array([np.cos(yaw), np.sin(yaw)])
    vel = (vel + acc_vec * dt) * VEL_DECAY
    n = np.linalg.norm(vel)
    if n > MAX_VEL:
        vel = vel * (MAX_VEL / n)
    pos = pos + vel * dt + 0.5 * acc_vec * dt * dt
    return yaw, pos, vel


@dataclass
class MovingObstacle:
    """A planar obstacle rendered as a vertical cylinder point cloud."""

    pos: np.ndarray                  # (2,)
    vel: np.ndarray = field(default_factory=lambda: np.zeros(2))
    yaw: float = 0.0
    radius: float = 0.5
    height: float = 3.0

    def update(self, dt: float, acc: float, yaw_rate: float):
        self.yaw, self.pos, self.vel = _dyn_update(
            dt, acc, yaw_rate, self.yaw, self.pos.copy(), self.vel.copy()
        )

    def predict(self, acc: float, yaw_rate: float, t_ahead: float,
                step: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
        """(pos, vel) t_ahead seconds ahead under constant controls
        (ref predict cpp:75-86, STEP=0.1 replay)."""
        yaw, pos, vel = self.yaw, self.pos.copy(), self.vel.copy()
        t = 0.0
        while t < t_ahead - 1e-9:
            h = min(step, t_ahead - t)
            yaw, pos, vel = _dyn_update(h, acc, yaw_rate, yaw, pos, vel)
            t += h
        return pos, vel

    def points(self, res: float = 0.15, rng=None) -> np.ndarray:
        """Cylinder surface+interior point cloud at the current pose."""
        rs = np.arange(res / 2, self.radius + 1e-9, res)
        pts = []
        for r in rs:
            n = max(int(2 * np.pi * r / res), 1)
            a = np.linspace(0, 2 * np.pi, n, endpoint=False)
            ring = np.stack([r * np.cos(a), r * np.sin(a)], axis=1)
            pts.append(ring)
        disk = np.concatenate(pts, axis=0) + self.pos[None, :]
        zs = np.arange(res / 2, self.height, res)
        cloud = np.concatenate(
            [np.concatenate([disk, np.full((len(disk), 1), z)], axis=1)
             for z in zs], axis=0)
        if rng is not None:
            cloud = cloud + rng.normal(scale=0.01, size=cloud.shape)
        return cloud


def predict_traj(obs: MovingObstacle, acc: float, yaw_rate: float, z: float,
                 pred_time: float = PRED_TIME, seg_num: int = SEG_NUM,
                 device=None, dtype: torch.dtype = torch.float32):
    """MINCO minimum-jerk fit through the predicted motion (ref
    predict_traj cpp:92-117) → PolyTraj on ``device`` (default: the CUDA
    card) in ``dtype``."""
    dev = resolve_device(device)
    dt = pred_time / seg_num
    inner = []
    for i in range(1, seg_num):
        p, _ = obs.predict(acc, yaw_rate, dt * i)
        inner.append([p[0], p[1], z])
    p_end, v_end = obs.predict(acc, yaw_rate, pred_time)

    head = np.zeros((3, 3))
    head[:, 0] = [obs.pos[0], obs.pos[1], z]
    head[:, 1] = [obs.vel[0], obs.vel[1], 0.0]
    tail = np.zeros((3, 3))
    tail[:, 0] = [p_end[0], p_end[1], z]
    tail[:, 1] = [v_end[0], v_end[1], 0.0]

    def on(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    T = torch.full((seg_num,), dt, dtype=dtype, device=dev)
    coeffs = minco.solve(on(inner), T, on(head), on(tail))
    return PolyTraj(T, coeffs)


def compose_map(static_points: np.ndarray, obstacles, res: float = 0.15,
                rng=None) -> np.ndarray:
    """Static map points + every obstacle's current point cloud."""
    clouds = [static_points] + [o.points(res=res, rng=rng) for o in obstacles]
    return np.concatenate(clouds, axis=0)
