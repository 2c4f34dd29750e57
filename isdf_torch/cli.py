"""Command-line runner (counterpart of ``isdf_tpu/cli.py``), in place of
``roslaunch plan_manager demoN.launch`` + RViz (ref
src/plan_manager/launch/demo*.launch): runs a demo scenario and writes the
trajectory CSV, the A* path, the swept-volume mesh OBJ, the HTML scene, the
monitor's artifacts and a metrics JSON into an output directory; or flies
the closed loop among moving obstacles.

    python -m isdf_torch.cli demo 1 --out /tmp/demo1 --iters 60
    python -m isdf_torch.cli closed-loop --out /tmp/cl
    python -m isdf_torch.cli demo 6 --fast --device cpu

Everything runs on ``--device`` (default ``cuda``: the card, or an error
where there is none); ``--device cpu`` runs the kernels' plain versions.
Demos 1–6 read their assets from the reference checkout at
``$ISDF_REFERENCE_ROOT``.  The JAX package's ``bench`` subcommand (the TPU
harness) has no counterpart yet.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _cmd_demo(args):
    import numpy as np

    from isdf_torch.demos import DEMOS, run_demo
    from isdf_torch.viz import export_obj, export_traj_csv, swept_volume_mesh

    os.makedirs(args.out, exist_ok=True)
    overrides = {}
    if args.fast:
        overrides = dict(
            integralIntervs=16, sweep_coarse_samples=32,
            sweep_refine_rounds=8, max_obstacle_points=1024,
        )
    monitor = None
    if args.monitor:
        from isdf_torch.utils.monitor import OptiMonitor
        from isdf_torch.utils.obs import Controller

        monitor = OptiMonitor(controller=Controller(), live=True)
    t0 = time.time()
    pm, res = run_demo(args.id, max_iters=args.iters,
                       conf_overrides=overrides, monitor=monitor,
                       device=args.device)
    wall = time.time() - t0
    planar = DEMOS[args.id].planar
    metrics = {k: v for k, v in res.metrics.items()
               if isinstance(v, (int, float, str, bool))}
    metrics["wall_s"] = wall
    metrics["success"] = bool(res.success)
    if res.success and not planar:
        metrics["min_swept_sdf"] = pm.audit_collision(res.traj)
        export_traj_csv(os.path.join(args.out, "trajectory.csv"), res.traj)
        np.savetxt(os.path.join(args.out, "astar_path.csv"), res.path,
                   delimiter=",", header="x,y,z")
        tris = None
        if args.swept_mesh:
            tris = swept_volume_mesh(
                pm.shape, res.traj, pm.params, resolution=args.mesh_res,
                device=args.device)
            export_obj(os.path.join(args.out, "swept_volume.obj"), tris)
            metrics["swept_mesh_tris"] = int(len(tris))
        if args.view:
            from isdf_torch.viz.html_view import export_plan_view

            swept = None
            if tris is not None:
                V = np.asarray(tris).reshape(-1, 3)
                F = np.arange(len(V)).reshape(-1, 3)
                swept = (V, F)
            vp = export_plan_view(
                os.path.join(args.out, "scene.html"), pm=pm, res=res,
                swept=swept, params=pm.params,
                title=f"demo {args.id}")
            metrics["view_html"] = vp
        if args.monitor:
            from isdf_torch.utils.monitor import (
                export_kernel_obj, export_replay_csv)

            export_replay_csv(
                os.path.join(args.out, "replay.csv"), res.traj, pm.params)
            if pm.pose_kernels is not None:
                export_kernel_obj(
                    os.path.join(args.out, "pose_kernel.obj"),
                    pm.pose_kernels,
                    resolution=pm.conf.occupancy_resolution)
    if monitor is not None and monitor.total:
        monitor.cost_curve_png(os.path.join(args.out, "cost_curve.png"))
        print(monitor.cost_curve_ascii())
        metrics["monitor"] = monitor.summary()
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2, default=str)
    print(json.dumps(metrics, default=str))


def _cmd_closed_loop(args):
    """Closed-loop replanning among moving obstacles (moving_obstacles +
    fake_drone + traj_server composition)."""
    import numpy as np

    from isdf_torch.config import Config
    from isdf_torch.plan import PlannerManager, fly_closed_loop
    from isdf_torch.world import MovingObstacle
    from isdf_torch.world.maps_gen import gene_wall

    os.makedirs(args.out, exist_ok=True)
    conf = Config(
        mapBound=(0.0, 14.0, 0.0, 10.0, 0.0, 4.0),
        occupancy_resolution=0.5, kernel_size=3, safety_hor=0.3,
        integralIntervs=8, sweep_coarse_samples=16, sweep_refine_rounds=6,
        max_obstacle_points=512, vmax=4.0, omgmax=6.0, thetamax=1.2,
        mem_size=8,
    )
    pm = PlannerManager(conf, shape_name="Ball", device=args.device)
    static = gene_wall(6.0, 0.0, 0.6, 3.5, 3.0, res=0.25)
    rng = np.random.default_rng(args.seed)
    obstacles = [
        MovingObstacle(pos=rng.uniform((4, 2), (11, 8)), radius=0.4,
                       height=3.0)
        for _ in range(args.n_obstacles)
    ]
    t0 = time.time()
    log = fly_closed_loop(
        pm, static, obstacles,
        start=np.array([1.0, 5.0, 2.0]), goal=np.array([13.0, 5.0, 2.0]),
        replan_dt=args.replan_dt, max_time=args.max_time,
        max_iters=args.iters, goal_tol=1.0, rng=rng,
    )
    wall = time.time() - t0
    out = {
        "reached": log.reached, "ticks": len(log.times),
        "min_body_sdf": log.min_sdf, "replans": len(log.replan_wall_s),
        "replan_p50_s": float(np.median(log.replan_wall_s))
        if log.replan_wall_s else None,
        "wall_s": wall,
    }
    np.savetxt(os.path.join(args.out, "flight.csv"),
               np.column_stack([log.times, np.asarray(log.positions)]),
               delimiter=",", header="t,x,y,z")
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="isdf_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device = dict(default="cuda",
                  help="torch device to run on (default: the CUDA card; "
                       "'cpu' runs the kernels' plain versions)")

    d = sub.add_parser("demo", help="run a reference demo scenario")
    d.add_argument("id", type=int, choices=range(1, 9))
    d.add_argument("--out", default="./out")
    d.add_argument("--iters", type=int, default=None)
    d.add_argument("--fast", action="store_true",
                   help="reduced resolutions for CPU smoke runs")
    d.add_argument("--swept-mesh", action="store_true")
    d.add_argument("--mesh-res", type=float, default=0.25)
    d.add_argument("--monitor", action="store_true",
                   help="live cost breakdown + cost_curve.png/replay.csv "
                        "artifacts (debug_assistant equivalent)")
    d.add_argument("--view", action="store_true",
                   help="write an interactive scene.html (map voxels, "
                        "trajectory, poses, swept mesh — the RViz role)")
    d.add_argument("--device", **device)
    d.set_defaults(fn=_cmd_demo)

    c = sub.add_parser("closed-loop",
                       help="replanning flight among moving obstacles")
    c.add_argument("--out", default="./out_cl")
    c.add_argument("--n-obstacles", type=int, default=2)
    c.add_argument("--replan-dt", type=float, default=1.5)
    c.add_argument("--max-time", type=float, default=30.0)
    c.add_argument("--iters", type=int, default=12)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--device", **device)
    c.set_defaults(fn=_cmd_closed_loop)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
