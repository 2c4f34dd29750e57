"""Goal injection and manual override for multi-agent demos (counterpart of
``isdf_tpu/plan/goals.py``, host numpy in both packages).

Equivalents of the reference's small `src/common/` nodes:

- ``GoalPool`` mirrors ``random_goals_node`` (ref
  src/common/random_goals/src/random_goals_node.cpp:63-153): a fixed pool of
  candidate goals; each agent, once it has *arrived and dwelled* at its goal,
  is handed a random unoccupied goal from the pool.  The ROS odometry
  subscription becomes an explicit ``update(agent_id, position)`` call from
  the closed-loop driver; the goal topic becomes the returned assignment.
- ``assign_goal`` mirrors ``assign_goals_node`` (ref
  src/common/assign_goals/src/assign_goals_node.cpp): direct user assignment
  of one goal to one agent.
- ``sample_free_goals`` draws uniformly random *free-space* goals from an
  occupancy grid (what the reference achieves by hand-placing goal yaml
  lists per map).
- ``ManualTakeOver`` mirrors ``manual_take_over`` (ref
  src/common/manual_take_over/src/manual_take_over.cpp:30-120 +
  ground_station.cpp): any stop button triggers a mandatory stop (planner
  commands are dropped); afterwards joystick axes integrate a
  velocity-limited position command (MAX_VEL 0.2 m/s) from the frozen pose.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class _AgentState:
    goal: Optional[np.ndarray] = None
    goal_id: int = -1
    position: Optional[np.ndarray] = None
    arrived_time: Optional[float] = None
    arrived_for_a_while: bool = True


class GoalPool:
    """Random goal rotation over a fixed candidate pool.

    Arrival = within ``arrive_radius`` of the assigned goal; a new goal is
    issued only after ``dwell_s`` of continuous arrival (the reference's
    ``arrived_for_a_while`` one-second timer,
    random_goals_node.cpp:108-139).
    """

    def __init__(self, goals: np.ndarray, n_agents: int,
                 arrive_radius: float = 0.5, dwell_s: float = 1.0,
                 seed: int = 0):
        self.goals = np.atleast_2d(np.asarray(goals, float))
        self.occupied = np.zeros(len(self.goals), dtype=bool)
        self.agents: List[_AgentState] = [_AgentState() for _ in range(n_agents)]
        self.arrive_radius = float(arrive_radius)
        self.dwell_s = float(dwell_s)
        self._rng = np.random.default_rng(seed)

    def _pick(self) -> int:
        free = np.flatnonzero(~self.occupied)
        if len(free) == 0:
            return -1
        return int(self._rng.choice(free))

    def update(self, agent_id: int, position, now: Optional[float] = None):
        """Feed an agent's current position; returns a newly-assigned goal
        (np.ndarray) when one is (re)issued, else None."""
        now = time.monotonic() if now is None else now
        st = self.agents[agent_id]
        st.position = np.asarray(position, float)

        if st.goal is None:
            gid = self._pick()
            if gid < 0:
                return None
            st.goal_id, st.goal = gid, self.goals[gid].copy()
            self.occupied[gid] = True
            return st.goal

        if np.linalg.norm(st.position - st.goal) < self.arrive_radius:
            if st.arrived_time is None:
                st.arrived_time = now
            elif now - st.arrived_time >= self.dwell_s and not st.arrived_for_a_while:
                st.arrived_for_a_while = True
                self.occupied[st.goal_id] = False
                gid = self._pick()
                if gid < 0:
                    return None
                st.goal_id, st.goal = gid, self.goals[gid].copy()
                self.occupied[gid] = True
                st.arrived_time = None
                st.arrived_for_a_while = False
                return st.goal
        else:
            st.arrived_time = None
            st.arrived_for_a_while = False
        return None


def assign_goal(pool: GoalPool, agent_id: int, goal) -> np.ndarray:
    """Directly assign a goal to an agent (ref assign_goals_node: RViz click
    → GoalSet for a selected drone), overriding any pool assignment."""
    st = pool.agents[agent_id]
    if st.goal_id >= 0:
        pool.occupied[st.goal_id] = False
    st.goal = np.asarray(goal, float)
    st.goal_id = -1
    st.arrived_time = None
    st.arrived_for_a_while = False
    return st.goal


def sample_free_goals(gm, n: int, seed: int = 0, clearance_vox: int = 1) -> np.ndarray:
    """Uniform random free-space goals from a GridMap occupancy grid (on
    any device; the draw is on the host)."""
    rng = np.random.default_rng(seed)
    occ = (gm.inflated(clearance_vox) if clearance_vox else gm).occ
    occ = occ.cpu().numpy()
    free = np.argwhere(~occ)
    if len(free) == 0:
        raise ValueError("map has no free voxels")
    idx = rng.choice(len(free), size=n, replace=len(free) < n)
    return np.asarray(gm.index_to_world(free[idx]))


@dataclass
class ManualTakeOver:
    """Joystick mandatory-stop + slow manual repositioning.

    ``feed_joy(buttons, axes)`` with any of the first four buttons pressed
    latches ``stopped`` (the reference publishes /mandatory_stop and the
    planner drops its commands, manual_take_over.cpp:37-44); once stopped,
    ``manual_command(dt)`` integrates axes → position at ≤ max_vel
    (manual_take_over.cpp:46-80).
    """

    max_vel: float = 0.2  # m/s, ref manual_take_over.cpp MAX_VEL
    stopped: bool = False
    pose: Optional[np.ndarray] = None   # frozen [x, y, z, yaw]
    _axes: np.ndarray = field(default_factory=lambda: np.zeros(4))

    def set_pose(self, pos, yaw: float = 0.0):
        self.pose = np.array([*np.asarray(pos, float)[:3], float(yaw)])

    def feed_joy(self, buttons, axes):
        """Returns True if a mandatory stop was triggered by this message."""
        self._axes = np.asarray(axes, float)[:4]
        if any(np.asarray(buttons[:4]).astype(bool)):
            first = not self.stopped
            self.stopped = True
            return first
        return False

    def manual_command(self, dt: float) -> Optional[np.ndarray]:
        """Next [x, y, z, yaw] command, or None when not in manual control."""
        if not self.stopped or self.pose is None:
            return None
        v = np.clip(self._axes * self.max_vel, -self.max_vel, self.max_vel)
        self.pose = self.pose + v * dt
        return self.pose.copy()

    def filter_command(self, cmd):
        """Gate a planner command: returns None (drop) while stopped."""
        return None if self.stopped else cmd
