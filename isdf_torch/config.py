"""Planner configuration.

This file is a verbatim copy of ``isdf_tpu/config.py`` (same class, same YAML
keys).  It is kept separate by rule: ``isdf_torch`` imports nothing of
``isdf_tpu``.  Edit both copies together.

Mirrors the key set of the reference's flat parameter struct
(ref: src/utils/include/utils/config.hpp:13-160) so that the per-demo YAML
files (src/plan_manager/config/*.yaml) can be loaded unchanged, but as a
frozen dataclass usable as a static argument to jit-compiled programs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Config:
    # --- parallel execution -------------------------------------------------
    threads_num: int = 30  # kept for config-file compatibility (unused on TPU)

    # --- robot shape --------------------------------------------------------
    inputdata: str = ""                   # mesh .obj path for Generalshape
    poly_params: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    # ^ (tx, ty, tz, yaw, pitch, roll); ref Shape.cpp:34-50
    use_objfile_as_body: bool = True
    selfmapresu: float = 0.1              # self-SDF grid resolution
    box_x: float = 1.0
    box_y: float = 1.0
    box_z: float = 1.0

    # --- map ----------------------------------------------------------------
    pcdmapname: str = ""
    mapBound: Tuple[float, ...] = (-25.0, 25.0, -25.0, 25.0, 0.0, 15.0)
    voxelWidth: float = 0.15
    dilateRadius: float = 0.5
    occupancy_resolution: float = 0.15
    sta_threshold: int = 1

    # --- collision kernels (front end) --------------------------------------
    kernel_size: int = 17                 # odd
    kernel_max_roll: float = 45.0         # degrees
    kernel_max_pitch: float = 45.0        # degrees
    kernel_ang_res: float = 9.0           # degrees
    front_end_safeh: float = 0.0

    # --- dynamics (flatness map) --------------------------------------------
    vehicleMass: float = 0.61
    gravAcc: float = 9.8
    horizDrag: float = 0.10
    vertDrag: float = 0.10
    parasDrag: float = 0.01
    speedEps: float = 1.0e-4

    # --- optimizer weights ---------------------------------------------------
    weight_v: float = 1000.0
    weight_a: float = 1000.0
    weight_p: float = 4000.0
    weight_pr: float = 1000.0
    weight_ar: float = 32000.0
    weight_omg: float = 1000.0
    weight_theta: float = 1000.0
    safety_hor: float = 0.6
    vmax: float = 10.0
    omgmax: float = 10.0
    thetamax: float = 100.0
    rho: float = 20.0
    rho_mid_end: float = 200.0
    inittime: float = 2.5
    smoothingEps: float = 1.0e-2
    integralIntervs: int = 64
    relCostTol: float = 1.0e-16
    relCostTolMidEnd: float = 1.0e-6

    # --- L-BFGS / outer loop -------------------------------------------------
    mem_size: int = 16
    past: int = 10
    min_step: float = 1.0e-32
    g_epsilon: float = 0.0
    RelCostTol: float = 1.0e-5
    max_iterations: int = 1000            # outer-loop hard cap (jit static)

    # --- swept volume --------------------------------------------------------
    enable_sweptvolume: bool = True
    momentum: float = 0.0
    t_min: float = 0.0
    t_max: float = 2.0
    eps: float = 0.2                      # swept-mesh voxel size
    torlerance: float = 0.005

    # --- misc / observability ------------------------------------------------
    debug_output: bool = False
    enableearlyExit: bool = False
    debugpause: int = 20
    testRate: float = 100.0
    ts: float = -1.0
    inittime_mid: float = 10.0
    offsetAABBbox: Tuple[float, ...] = (0.0, 0.0, 0.0)
    test_obs: Tuple[float, ...] = ()
    polyV: Tuple[float, ...] = ()
    meshTopic: str = ""
    edgeTopic: str = ""
    vertexTopic: str = ""
    transparency: float = 0.5

    # --- TPU-build specific knobs (no reference equivalent) ------------------
    traj_parlength: float = 3.0           # waypoint subsample arc length
    # ^ ref plan_manager.cpp:153 hardcodes traj_parlength = 3.0
    attitude_bridge: bool = True          # hold attitude between rolled
    # waypoints (geodesic-lerped refs; see opt/attitude.attitude_penalty)
    weight_ar_backend: float = 0.0        # back-end attitude anchor weight
    # (no reference equivalent; opt-in — anchors the SE(3) warm-start roll
    # against being unwound mid-crossing, but over-constrains scenes where
    # gentler poses suffice — see opt/backend.make_cost_fn)
    sweep_coarse_samples: int = 128       # coarse time-grid resolution
    sweep_refine_rounds: int = 24         # fixed zoom/descent rounds
    max_obstacle_points: int = 4096       # static obstacle-point budget
    safety_replan_rounds: int = 2         # post-audit violation re-solves
    # waypoint-count buckets: plans resample the A* path to the next bucket
    # size so repeated plans reuse compiled executables (0 = disabled)
    piece_buckets: Tuple[int, ...] = (4, 6, 8, 12, 16, 24, 32, 48, 64)
    dtype: str = "float32"

    # ------------------------------------------------------------------------
    @property
    def kernel_bd(self) -> float:
        """Robot bounding-box edge (ref back_end_optimizer.hpp:692)."""
        return self.kernel_size * self.occupancy_resolution

    @property
    def n_roll(self) -> int:
        return int(round(2 * self.kernel_max_roll / self.kernel_ang_res)) + 1

    @property
    def n_pitch(self) -> int:
        return int(round(2 * self.kernel_max_pitch / self.kernel_ang_res)) + 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in raw.items():
            if k not in names:
                continue
            if isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)
