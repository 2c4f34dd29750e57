"""Closed-loop replanning among moving obstacles (counterpart of
``isdf_tpu/plan/closed_loop.py``).

The reference composes this flow from ROS nodes (moving_obstacles →
/globalmap points, plan_manager replanning on demand, traj_server's 100 Hz
commands, fake_drone's odometry echo); here it is one host loop over the
same engine pieces:

    every replan tick:
        advance the obstacles (decayed-velocity dynamics, world/moving.py)
        recompose the map points → occupancy grid (pose kernels reused)
        replan from the commanded state (pos/vel/acc head rows), through K1
        serve the fresh trajectory's commands (plan/traj_server.py)

The audit runs at the ticks flown: the body SDF at the commanded position
against the occupied voxels of the current map, computed on the device, of
which one float comes back.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from isdf_torch.plan.manager import PlannerManager
from isdf_torch.plan.traj_server import sample_horizon
from isdf_torch.world.gridmap import GridMap
from isdf_torch.world.moving import MovingObstacle, compose_map


@dataclass
class FlightLog:
    times: List[float] = field(default_factory=list)
    positions: List[np.ndarray] = field(default_factory=list)
    velocities: List[np.ndarray] = field(default_factory=list)
    min_body_sdf: List[float] = field(default_factory=list)
    replan_wall_s: List[float] = field(default_factory=list)
    setup_wall_s: List[float] = field(default_factory=list)  # map + set_map
    reached: bool = False

    @property
    def min_sdf(self) -> float:
        return min(self.min_body_sdf) if self.min_body_sdf else float("inf")


def _occupied_centers(gm: GridMap, dtype: torch.dtype) -> torch.Tensor:
    """World coordinates of the occupied voxels' centers, on the map's
    device."""
    idx = torch.nonzero(gm.occ).to(dtype)
    return gm.origin.to(dtype) + (idx + 0.5) * gm.resolution


def _min_body_sdf(pm: PlannerManager, pos: np.ndarray,
                  occ: torch.Tensor) -> float:
    """Body SDF (zero attitude) at ``pos`` against the occupied voxel
    centers ``occ`` (M, 3) within ``kernel_bd`` of it; inf if none."""
    if len(occ) == 0:
        return float("inf")
    with torch.no_grad():
        p = torch.as_tensor(pos, dtype=occ.dtype, device=occ.device)
        rel = occ - p
        near = torch.linalg.norm(rel, dim=1) < pm.conf.kernel_bd
        sdf = pm.shape.sdf(rel)
        return float(torch.min(torch.where(
            near, sdf, torch.full_like(sdf, float("inf")))))


def fly_closed_loop(pm: PlannerManager, static_points: np.ndarray,
                    obstacles: Sequence[MovingObstacle], start, goal,
                    obstacle_controls=None, replan_dt: float = 1.0,
                    cmd_rate: float = 100.0, max_time: float = 60.0,
                    goal_tol: float = 0.8, max_iters: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None,
                    live_view=None) -> FlightLog:
    """Fly start → goal while the obstacles move; replan every replan_dt.

    obstacle_controls(i, t, rng) → (acc, yaw_rate) per obstacle; by default
    random accelerations, as the reference's obstacle node draws them.  The
    planner runs on ``pm.device``.  live_view: optional
    viz.live_view.LiveFlightView — streams the map, the latest plan and the
    flown pose trail to the browser while flying (the odom_visualization /
    rviz role); it reads host arrays after each replan and changes nothing
    the flight computes.  → a FlightLog with the audit at the ticks flown
    and the wall time of each replan and of each map set-up."""
    rng = rng or np.random.default_rng(0)
    if obstacle_controls is None:
        def obstacle_controls(i, t, rng):
            return float(rng.uniform(0.5, 2.0)), float(rng.uniform(-1.0, 1.0))

    log = FlightLog()
    pos = np.asarray(start, dtype=np.float64).copy()
    vel = np.zeros(3)
    acc = np.zeros(3)
    goal = np.asarray(goal, dtype=np.float64)
    t = 0.0
    last_yaw = 0.0
    n_cmd = max(int(replan_dt * cmd_rate), 1)
    conf = pm.conf

    while t < max_time:
        # 1. advance the obstacles and recompose the map
        t0 = time.perf_counter()
        for i, ob in enumerate(obstacles):
            a, yr = obstacle_controls(i, t, rng)
            ob.update(replan_dt, a, yr)
        pts = compose_map(static_points, obstacles,
                          res=conf.occupancy_resolution / 2)
        gm = GridMap.from_points(pts, conf.mapBound,
                                 conf.occupancy_resolution,
                                 conf.sta_threshold, device=pm.device)
        pm.set_map(gm, use_pose_kernels=pm.pose_kernels is not None
                   or pm.feasibility is not None)
        occ = _occupied_centers(gm, pm.dtype)
        if pm.device.type == "cuda":
            torch.cuda.synchronize(pm.device)
        log.setup_wall_s.append(time.perf_counter() - t0)
        if live_view is not None:
            live_view.set_scene(points=pts, goal=goal)

        # 2. replan from the commanded state
        t0 = time.perf_counter()
        res = pm.plan(pos, goal, max_iters=max_iters, start_vel=vel,
                      start_acc=acc)
        log.replan_wall_s.append(time.perf_counter() - t0)
        if not res.success:
            break

        # 3. serve one replan window of commands; the drone follows them.
        # last_yaw carries across replans so the rate-limited yaw chain is
        # continuous at horizon boundaries (ref traj_server.cpp:85-144)
        cmds = sample_horizon(res.traj, 0.0, n_cmd, rate=cmd_rate,
                              last_yaw=last_yaw)
        last_yaw = float(cmds.yaw[-1])
        p_np, v_np, a_np = cmds.position, cmds.velocity, cmds.acceleration
        for k in range(n_cmd):
            log.times.append(t + (k + 1) / cmd_rate)
            log.positions.append(p_np[k])
            log.velocities.append(v_np[k])
        # the audit at a thinned set of the ticks flown
        for k in range(0, n_cmd, max(n_cmd // 10, 1)):
            log.min_body_sdf.append(_min_body_sdf(pm, p_np[k], occ))
        if live_view is not None:
            traj = res.traj.detach()
            dur = traj.durations
            with torch.no_grad():
                plan_xyz = traj.pos(torch.linspace(
                    0.0, float(traj.total_duration), 64, dtype=dur.dtype,
                    device=dur.device)).cpu().numpy()
            live_view.set_plan(plan_xyz)
            for k in range(0, n_cmd, max(n_cmd // 10, 1)):
                live_view.update(
                    t + (k + 1) / cmd_rate, p_np[k],
                    speed=float(np.linalg.norm(v_np[k])),
                    min_body_sdf=float(log.min_body_sdf[-1]),
                    replan_wall_s=float(log.replan_wall_s[-1]),
                )
        pos, vel, acc = p_np[-1].copy(), v_np[-1].copy(), a_np[-1].copy()
        t += replan_dt

        if np.linalg.norm(pos - goal) < goal_tol:
            log.reached = True
            break

    return log
