"""Trajectory serving: 100 Hz position commands (counterpart of
``isdf_tpu/plan/traj_server.py``; ref src/plan_manager/src/traj_server.cpp:
85-144 yaw planning, 173-319 cmdCallback, 332 the 100 Hz timer, 186-192 the
heartbeat watchdog).

A command holds pos/vel/acc/jerk and a velocity-aligned yaw with a rate
limit; past the trajectory's end it holds the final position (hover).  A
horizon of n ticks is one batched polynomial evaluation on the trajectory's
device and one transfer to the host; the rate-limited yaw chain, a
sequential recurrence of n scalar steps, then runs on the host in float64
(one small kernel per tick would make serving host-bound for nothing).
Commands are host numpy arrays.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch


class PositionCommand(NamedTuple):
    position: np.ndarray      # (..., 3)
    velocity: np.ndarray
    acceleration: np.ndarray
    jerk: np.ndarray
    yaw: np.ndarray           # (...)
    yaw_dot: np.ndarray


# ref traj_server.cpp:85-144: the yaw tracks the velocity direction, rate
# limited
_YAW_DOT_MAX = math.pi / 2      # rad/s (ref YAW_DOT_MAX_PER_SEC)


def _sample(traj, ts: torch.Tensor, last_yaw: float,
            dt: float) -> PositionCommand:
    """Commands at times ts (n,) on the trajectory's device, the yaw chain
    seeded with last_yaw → a PositionCommand of (n, 3) and (n,) arrays."""
    with torch.no_grad():
        total = traj.total_duration
        tc = torch.minimum(torch.clamp(ts, min=0.0), total)
        pos, vel, acc, jer = traj.detach().pvaj(tc)
        ended = (ts >= total)[:, None]
        zero = torch.zeros_like(vel)
        vel, acc, jer = (torch.where(ended, zero, x) for x in (vel, acc, jer))
        host = torch.stack([pos, vel, acc, jer]).cpu().double().numpy()
    pos, vel, acc, jer = host
    n = len(ts)
    yaw = np.empty(n)
    yaw_dot = np.empty(n)
    max_d = _YAW_DOT_MAX * dt
    last = float(last_yaw)
    for k in range(n):
        vx, vy = float(vel[k, 0]), float(vel[k, 1])
        speed = math.sqrt(vx * vx + vy * vy)
        yaw_des = math.atan2(vy, vx) if speed > 0.1 else last
        dy = math.atan2(math.sin(yaw_des - last), math.cos(yaw_des - last))
        step = min(max(dy, -max_d), max_d)
        last = last + step
        yaw[k] = last
        yaw_dot[k] = step / dt
    return PositionCommand(pos, vel, acc, jer, yaw, yaw_dot)


def _times(traj, t0: float, n: int, dt: float) -> torch.Tensor:
    dur = traj.durations
    return t0 + torch.arange(n, dtype=dur.dtype, device=dur.device) * dt


def sample_command(traj, t: float, last_yaw: float,
                   dt: float) -> PositionCommand:
    """One command tick at time t (clipped to the trajectory: hover at the
    end) → arrays of shape (3,) and ()."""
    cmd = _sample(traj, _times(traj, t, 1, dt), last_yaw, dt)
    return PositionCommand(*(a[0] for a in cmd))


def sample_horizon(traj, t0: float, n: int, rate: float = 100.0,
                   last_yaw: float = 0.0) -> PositionCommand:
    """The command horizon [t0, t0 + n/rate) → arrays of shape (n, 3) and
    (n,).  ``last_yaw`` seeds the rate-limited yaw chain: a closed loop
    passes the yaw it served last, so commands stay continuous across
    horizons (the discontinuity the reference's rate limit prevents)."""
    dt = 1.0 / rate
    return _sample(traj, _times(traj, float(t0), n, dt), last_yaw, dt)


class TrajServer:
    """Stateful host-side server with the heartbeat watchdog."""

    def __init__(self, rate: float = 100.0, heartbeat_timeout: float = 0.5):
        self.rate = rate
        self.heartbeat_timeout = heartbeat_timeout
        self.traj = None
        self.traj_stamp = 0.0
        self.last_heartbeat = 0.0
        self.last_yaw = 0.0
        self._frozen_cmd: Optional[PositionCommand] = None

    def set_trajectory(self, traj, stamp: Optional[float] = None):
        self.traj = traj
        self.traj_stamp = time.time() if stamp is None else stamp
        self._frozen_cmd = None

    def heartbeat(self):
        self.last_heartbeat = time.time()

    def command(self, now: Optional[float] = None
                ) -> Optional[PositionCommand]:
        if self.traj is None:
            return None
        now = time.time() if now is None else now
        if (self.last_heartbeat
                and now - self.last_heartbeat > self.heartbeat_timeout):
            # watchdog: freeze at the last position (ref
            # traj_server.cpp:186-192)
            if self._frozen_cmd is None:
                self._frozen_cmd = self._sample(now)._replace(
                    velocity=np.zeros(3), acceleration=np.zeros(3),
                    jerk=np.zeros(3), yaw_dot=np.asarray(0.0))
            return self._frozen_cmd
        cmd = self._sample(now)
        self.last_yaw = float(cmd.yaw)
        return cmd

    def _sample(self, now: float) -> PositionCommand:
        return sample_command(self.traj, now - self.traj_stamp,
                              self.last_yaw, 1.0 / self.rate)
