from isdf_torch.viz.swept_mesh import swept_volume_mesh, sdf_volume  # noqa: F401
from isdf_torch.viz.export import export_obj, export_traj_csv, sdf_time_curve, export_sdf_curve_csv  # noqa: F401
