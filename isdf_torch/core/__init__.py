from isdf_torch.core.poly import PolyTraj  # noqa: F401
from isdf_torch.core import minco, flatness, smoothing, timemap, so3  # noqa: F401
