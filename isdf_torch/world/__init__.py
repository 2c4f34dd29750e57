from isdf_torch.world.gridmap import GridMap  # noqa: F401
from isdf_torch.world import maps_gen, aabb  # noqa: F401
