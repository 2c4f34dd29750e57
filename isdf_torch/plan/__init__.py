from isdf_torch.plan.manager import PlannerManager, PlanResult  # noqa: F401
from isdf_torch.plan.traj_server import TrajServer  # noqa: F401
from isdf_torch.plan.closed_loop import FlightLog, fly_closed_loop  # noqa: F401
from isdf_torch.plan.goals import (  # noqa: F401
    GoalPool, ManualTakeOver, assign_goal, sample_free_goals,
)
from isdf_torch.plan.planar import PlanarResult, plan_planar, audit_planar  # noqa: F401
