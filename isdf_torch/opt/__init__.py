from isdf_torch.opt.lbfgs import minimize as lbfgs_minimize  # noqa: F401
from isdf_torch.opt import backend, midend  # noqa: F401
