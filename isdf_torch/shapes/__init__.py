from isdf_torch.shapes import primitives, ops  # noqa: F401
from isdf_torch.shapes.zoo import Shape, make_shape, SHAPE_REGISTRY  # noqa: F401
from isdf_torch.shapes.gridsdf import (  # noqa: F401
    grid_shape, mesh_shape, shape_from_config)
