"""Kinematic "fake drone": position commands echoed as odometry
(counterpart of ``isdf_tpu/sim/fake_drone.py``; ref src/uav_simulator/
fake_drone/src/poscmd_2_odom.cpp:16-60 — the demo pipeline's closed-loop
stand-in for the dynamics sim: odom pose = command pose, orientation = yaw
about z).  The port's commands (plan/traj_server.PositionCommand) are host
numpy arrays, and so is the odometry."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Odometry(NamedTuple):
    position: np.ndarray
    velocity: np.ndarray
    quat_wxyz: np.ndarray


def cmd_to_odom(cmd) -> Odometry:
    """PositionCommand → Odometry (pure kinematic echo)."""
    half = 0.5 * np.asarray(cmd.yaw)
    quat = np.stack(
        [np.cos(half), np.zeros_like(half), np.zeros_like(half),
         np.sin(half)], axis=-1)
    return Odometry(position=cmd.position, velocity=cmd.velocity,
                    quat_wxyz=quat)
