from isdf_torch.plan.manager import PlannerManager, PlanResult  # noqa: F401
