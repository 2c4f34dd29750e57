from isdf_torch.sim.quadrotor import QuadrotorParams, QuadState, step as quad_step, rollout  # noqa: F401
from isdf_torch.sim.so3_control import SO3ControlGains, so3_control  # noqa: F401
from isdf_torch.sim.fake_drone import cmd_to_odom  # noqa: F401
from isdf_torch.sim.depth_render import (  # noqa: F401
    CameraIntrinsics, render_depth, render_pointcloud,
)
