"""The six reference demo scenarios as runnable specs.

Mirrors roslaunch plan_manager demo{1..6}.launch (ref
src/plan_manager/launch/demo*.launch + config/config_*.yaml):

  demo1: RoundedCone body (roll 120°), CappedCone.pcd random-block map
  demo2: BendLinear_big body, Bendlinear_big.pcd map
  demo3: SmoothIntersection_big body (rpy 20,50,0), SmoothIntersection.pcd
  demo4: Torus_big body (rpy 10,0,80), Torus_big.pcd map
  demo5: mybox.obj mesh body, generated map 9 (slit ramp)
  demo6: Lthick.obj mesh body (the L-shape), generated map 3 (three slits)

Parameter values are transcribed from the corresponding YAMLs; asset files
(.obj meshes, .pcd maps) are read from the reference checkout when present
(REFERENCE_ROOT), since they are data inputs, not code.

Counterpart of ``isdf_tpu/demos.py``: the same specs (``DEMOS`` equals the
JAX package's, field for field), with ``run_demo`` on ``device`` (default:
the CUDA card).  The reference checkout is ``$ISDF_REFERENCE_ROOT`` and has
no default: while it is unset the asset paths in ``DEMOS`` stay relative to
it, and a demo that reads an asset (1–6) raises FileNotFoundError, as the
JAX package's raise without the checkout.  Demos 7 and 8 need no asset.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from isdf_torch.config import Config

REFERENCE_ROOT = os.environ.get("ISDF_REFERENCE_ROOT", "")
_PM = os.path.join(REFERENCE_ROOT, "src", "plan_manager")


def _need_reference(demo_id: int) -> None:
    if not REFERENCE_ROOT:
        raise FileNotFoundError(
            f"demo {demo_id} reads its assets from the reference checkout: "
            "set $ISDF_REFERENCE_ROOT")

_COMMON = dict(
    selfmapresu=0.05,
    voxelWidth=0.15,
    mapBound=(-25.0, 25.0, -25.0, 25.0, 0.0, 15.0),
    occupancy_resolution=1.0,
    sta_threshold=1,
    kernel_max_pitch=45.0, kernel_max_roll=45.0, kernel_ang_res=9.0,
    front_end_safeh=0.0,
    smoothingEps=1.0e-2,
    integralIntervs=64,
    rho_mid_end=200.0,
    inittime=2.5,
    mem_size=16,
    past=10,
    vehicleMass=0.61, gravAcc=9.8, horizDrag=0.10, vertDrag=0.10,
    parasDrag=0.01, speedEps=1.0e-4,
    weight_v=1000.0, weight_a=1000.0, weight_p=4000.0, weight_pr=1000.0,
    # weight_ar: the reference YAMLs say 32000, but that value belongs to the
    # attitude penalty the reference never invokes (addTimeIntPenalty is not
    # called by mid_end's costFunction).  Our wired implementation adds
    # peak-hold ref resampling + window bridging, which roughly triples the
    # effective tracking strength.  Measured sensitivity on demo6 (BASELINE.md
    # "weight_ar sensitivity"): 2000 → clearance +0.62 m, 8000 → +0.58 m,
    # 32000 → −0.51 m (COLLIDES — attitude tracking over-dominates the
    # safety penalty); the cliff sits between 8000 and 32000, so 2000 is
    # kept — attitude refs are guidance for the swept-SDF penalty, not a
    # hard constraint.
    weight_ar=2000.0, weight_omg=1000.0, weight_theta=1000.0,
)


@dataclass(frozen=True)
class DemoSpec:
    demo_id: int
    config: Config
    pcd: Optional[str] = None       # pcd file name under map_pcds/
    map_id: Optional[int] = None    # procedural map id (maps_gen)
    start: tuple = (2.0, 2.0, 2.0)
    goal: tuple = (45.0, 45.0, 3.0)
    # 2-D planar mode (demos 7/8 — the paper's 2-D experiments; the
    # reference repo ships no 2-D code path): shape_name picks the body,
    # planar_map the maps_gen generator, yaw_opt the rotation mode
    planar: bool = False
    shape_name: Optional[str] = None
    planar_map: Optional[str] = None
    yaw_opt: bool = True


DEMOS = {
    1: DemoSpec(
        1,
        Config.from_dict(dict(
            _COMMON, inputdata=os.path.join(_PM, "shapes/RoundedCone.obj"),
            poly_params=(0.0, 0.0, 0.0, 120.0, 0.0, 0.0),
            kernel_size=13, vmax=10.0, omgmax=10.0, thetamax=100.0,
            rho=20.0, safety_hor=0.866,
        )),
        pcd="CappedCone.pcd",
    ),
    2: DemoSpec(
        2,
        Config.from_dict(dict(
            _COMMON, inputdata=os.path.join(_PM, "shapes/BendLinear_big.obj"),
            poly_params=(0.0,) * 6,
            kernel_size=15, vmax=1000.0, omgmax=1000.0, thetamax=10000.0,
            rho=380.0, safety_hor=0.866,
        )),
        pcd="Bendlinear_big.pcd",
        # endpoints picked in deep zero-pose-feasible free space (the
        # reference takes interactive RViz clicks; there is no canonical pair)
        start=(11.5, 4.5, 2.5), goal=(45.5, 45.5, 2.5),
    ),
    3: DemoSpec(
        3,
        Config.from_dict(dict(
            _COMMON,
            inputdata=os.path.join(_PM, "shapes/SmoothIntersection_big.obj"),
            poly_params=(0.0, 0.0, 0.0, 20.0, 50.0, 0.0),
            kernel_size=13, vmax=300.0, omgmax=300.0, thetamax=3000.0,
            rho=380.0, safety_hor=0.866,
        )),
        pcd="SmoothIntersection.pcd",
        # deep-free endpoints: the 6.5 m-wide body collides at the generic
        # (2,2,2) corner start (see demo2 note)
        start=(16.5, 4.5, 2.5), goal=(35.5, 43.5, 2.5),
    ),
    4: DemoSpec(
        4,
        Config.from_dict(dict(
            _COMMON, inputdata=os.path.join(_PM, "shapes/Torus_big.obj"),
            poly_params=(0.0, 0.0, 0.0, 10.0, 0.0, 80.0),
            kernel_size=13, vmax=1000.0, omgmax=1000.0, thetamax=10000.0,
            rho=380.0, safety_hor=0.866,
        )),
        pcd="Torus_big.pcd",
    ),
    5: DemoSpec(
        5,
        Config.from_dict(dict(
            _COMMON, inputdata=os.path.join(_PM, "shapes/mybox.obj"),
            poly_params=(0.0,) * 6,
            kernel_size=17, vmax=10.0, omgmax=10.0, thetamax=100.0,
            rho=20.0, safety_hor=0.866,
            box_x=3.0, box_y=0.3, box_z=0.3,
        )),
        map_id=9,
        start=(5.0, 20.0, 8.0), goal=(45.0, 20.0, 25.0),
    ),
    6: DemoSpec(
        6,
        Config.from_dict(dict(
            _COMMON, inputdata=os.path.join(_PM, "shapes/Lthick.obj"),
            poly_params=(0.0,) * 6,
            kernel_size=17, vmax=10.0, omgmax=10.0, thetamax=100.0,
            rho=20.0, safety_hor=0.6,
        )),
        map_id=3,
        start=(5.0, 5.0, 5.0), goal=(40.0, 5.0, 5.0),
    ),
    # 2-D experiments (BASELINE.json: "2D circle robot, rotation decoupled"
    # and "2D arbitrary polygon with yaw optimization")
    7: DemoSpec(
        7,
        Config.from_dict(dict(
            occupancy_resolution=0.5, integralIntervs=16,
            sweep_coarse_samples=48, sweep_refine_rounds=8,
            vmax=5.0, omgmax=5.0, thetamax=1e3, safety_hor=0.3,
            max_obstacle_points=2048, inittime=2.0, weight_p=8000.0,
        )),
        start=(2.0, 2.0), goal=(28.0, 28.0),
        planar=True, shape_name="Ball", planar_map="planar_forest",
        yaw_opt=False,
    ),
    8: DemoSpec(
        8,
        Config.from_dict(dict(
            occupancy_resolution=0.5, integralIntervs=16,
            sweep_coarse_samples=64, sweep_refine_rounds=8,
            vmax=4.0, omgmax=3.0, thetamax=1e3, safety_hor=0.25,
            max_obstacle_points=2048, inittime=2.0, weight_p=8000.0,
            box_x=1.4, box_y=0.2, box_z=0.2,
        )),
        start=(3.0, 3.0), goal=(21.0, 21.0),
        planar=True, shape_name="Box", planar_map="planar_gaps",
        yaw_opt=True,
    ),
}


def load_demo_points(spec: DemoSpec, res: float = 0.8, seed: int = 0) -> np.ndarray:
    if spec.pcd is not None:
        from isdf_torch.world.pcd import load_pcd

        _need_reference(spec.demo_id)
        return load_pcd(os.path.join(_PM, "map_pcds", spec.pcd))
    from isdf_torch.world import maps_gen

    return maps_gen.generate(spec.map_id, res=res, seed=seed)


def run_demo(demo_id: int, start=None, goal=None,
             max_iters: Optional[int] = None, use_pose_kernels: bool = True,
             conf_overrides: Optional[dict] = None, monitor=None,
             device=None):
    """Full pipeline on a demo scenario on ``device`` (default: the CUDA
    card); returns (PlannerManager, PlanResult) for 3-D demos, or (shape,
    PlanarResult) for the 2-D demos 7/8.

    NB the grid is sized to the point cloud's bounding box, matching the
    reference's PCSmapManager (PCSmap_manager.cpp:111-145 measures the cloud
    and createGridMap's on its bbox; conf.mapBound is not used for the grid
    there either)."""
    from isdf_torch.device import resolve_device
    from isdf_torch.plan import PlannerManager
    from isdf_torch.shapes.gridsdf import shape_from_config
    from isdf_torch.world import GridMap

    dev = resolve_device(device)
    spec = DEMOS[demo_id]
    conf = spec.config if not conf_overrides else spec.config.replace(
        **conf_overrides)

    if spec.planar:
        from isdf_torch.plan import plan_planar
        from isdf_torch.shapes import make_shape
        from isdf_torch.world import maps_gen

        shape = make_shape(spec.shape_name, conf)
        pts2 = getattr(maps_gen, spec.planar_map)()
        res = plan_planar(
            conf, shape, pts2,
            start if start is not None else spec.start,
            goal if goal is not None else spec.goal,
            yaw_opt=spec.yaw_opt, max_iters=max_iters, device=dev,
        )
        return shape, res

    _need_reference(demo_id)
    shape = shape_from_config(conf, device=dev)
    pm = PlannerManager(conf, shape=shape, device=dev)
    pts = load_demo_points(spec)
    gm = GridMap.from_points(
        pts, None, conf.occupancy_resolution, conf.sta_threshold, device=dev
    )
    pm.set_map(gm, use_pose_kernels=use_pose_kernels)
    res = pm.plan(
        np.asarray(start if start is not None else spec.start,
                   dtype=np.float64),
        np.asarray(goal if goal is not None else spec.goal, dtype=np.float64),
        max_iters=max_iters, monitor=monitor,
    )
    return pm, res
