from isdf_torch.sweep.sweep_sdf import (  # noqa: F401
    sweep_sdf,
    sweep_sdf_warm,
    traj_states,
    sdf_at_time,
)
