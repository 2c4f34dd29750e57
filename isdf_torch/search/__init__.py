from isdf_torch.search.pose_kernels import build_pose_kernels, pose_feasibility  # noqa: F401
from isdf_torch.search.astar import astar_se3, AstarResult  # noqa: F401
