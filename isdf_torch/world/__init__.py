from isdf_torch.world.gridmap import GridMap  # noqa: F401
from isdf_torch.world import maps_gen, aabb  # noqa: F401
from isdf_torch.world.moving import MovingObstacle, predict_traj, compose_map  # noqa: F401
