from isdf_torch.shapes import primitives, ops  # noqa: F401
from isdf_torch.shapes.zoo import Shape, make_shape, SHAPE_REGISTRY  # noqa: F401
