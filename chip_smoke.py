#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``isdf_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel from the sources, all nvcc processes
               started together (K1, K2 and K4: isdf_torch/csrc/sweep_warm.cu,
               one library per body-SDF kind; K3: isdf_torch/csrc/
               grid_sweep.cu) and print the seconds;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               and time both with CUDA events:
               K1 against sweep_warm_fused_ref for RoundedCone (posed), Ball
               and CappedCone, at the slice's size, at the JAX bench's size
               and at the audit's two sizes, and for the other 17 zoo shapes
               at the slice's size;
               K2 against sweep_warm_fused_batched_ref and against K1
               launched per scenario, at B = 64 × P = 512, for CappedCone,
               CSG and Trefoil; then against its plain version and timed at
               the shapes the batched solves launch it at: warm at B = 128
               (every scenario) and B = 4096 (five scenarios), and cold at
               the audit's coarse_n = 512 at B = 128;
               K4 against zoom_refine_ref at the slice's size;
               K3 against grid_sweep_warm_fused_ref on the L robot's baked
               field at the mesh slice's size (warm) and at the audit's two
               sizes (cold), on the JAX bench's 64³ torus field, on a 192³
               field (past the TPU's VMEM budget), and batched at B = 64,
               also against K3 launched per scenario;
  3. plan    — PlannerManager.plan on the demo-1 scene (RoundedCone body,
               procedural map4), with the launch counters set to 0 just
               before the plan and read just after; then zoom_refine (K4,
               which nothing in the package calls) on the audit's argmin
               times at the plan's voxels, its counter set to 0 just before,
               held against zoom_refine_ref on the same tensors;
  4. batch   — the scenario-batched back end (isdf_torch.parallel.batch) at
               the width the JAX bench runs it (CappedCone, N = 4 pieces,
               P = 512 points, max_iters = 24, chunk = 8): make_random_batch
               and batched_solve_chunked at B = 128 and B = 4096,
               batched_solve_audited at B = 128; the launch counters are set
               to 0 just before the B = 128 solve and read just after;
  5. mesh    — a mesh robot: the demo-6 scene (an L-shaped thick prism
               written as an OBJ file, baked through shape_from_config;
               procedural map3) through PlannerManager.plan, K3's counter set
               to 0 just before the plan and read just after; then
               batched_solve_chunked with the L robot at the bench's width
               (B = 128), the counter set to 0 just before.
With ``--profile`` it then plans once more under torch.profiler, solves the
B = 4096 batch once more under it and plans the mesh scene once more under
it, and prints the device's busy share of each.  Then it prints the card's
name and power limit, one JSON line with the kernels' numbers, and as the
last line {"ok": true, "device": {...}}.
Without a CUDA card, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# The sweep kernels' tolerance against their plain versions (both float32 on
# the card).  The
# band stays for rounding differences: the gradient comes from dual numbers in
# the kernel and from autograd in the plain version, and a one-ulp change of
# an SDF value at a near-tie can move t* to a neighbouring candidate of equal
# depth.
D_ATOL, D_RTOL = 2e-4, 1e-4
T_AGREE, T_SHARE = 1e-4, 0.99
G_ATOL = 1e-3

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# demo 1 (isdf_tpu/demos.py:31-59 _COMMON and :80-89): RoundedCone posed by
# roll 120°; demo 1's own CappedCone.pcd is not in the repo, so its
# procedural map4 ("random floating blocks (demo1's map)") stands in
DEMO1 = dict(
    selfmapresu=0.05, voxelWidth=0.15,
    mapBound=(-25.0, 25.0, -25.0, 25.0, 0.0, 15.0),
    occupancy_resolution=1.0, sta_threshold=1,
    kernel_max_pitch=45.0, kernel_max_roll=45.0, kernel_ang_res=9.0,
    front_end_safeh=0.0, smoothingEps=1.0e-2, integralIntervs=64,
    rho_mid_end=200.0, inittime=2.5, mem_size=16, past=10,
    vehicleMass=0.61, gravAcc=9.8, horizDrag=0.10, vertDrag=0.10,
    parasDrag=0.01, speedEps=1.0e-4,
    weight_v=1000.0, weight_a=1000.0, weight_p=4000.0, weight_pr=1000.0,
    weight_ar=2000.0, weight_omg=1000.0, weight_theta=1000.0,
    poly_params=(0.0, 0.0, 0.0, 120.0, 0.0, 0.0),
    kernel_size=13, vmax=10.0, omgmax=10.0, thetamax=100.0,
    rho=20.0, safety_hor=0.866,
    sweep_coarse_samples=128, sweep_refine_rounds=24,
    max_obstacle_points=4096,
)
START, GOAL = (2.0, 2.0, 2.0), (45.0, 45.0, 3.0)
MAX_ITERS = 200     # back-end iteration cap for the smoke run


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# the kernel phase runs every case before it fails, so one run shows every
# case outside its band
KERNEL_FAILURES = []


def check_kernel(cond: bool, what: str) -> None:
    if not cond:
        print("kernel check failed: " + what, flush=True)
        KERNEL_FAILURES.append(what)


# ---------------------------------------------------------------------------
# K1 operation count, per query point, read off isdf_torch/csrc/sweep_warm.cu:
# every FP32 add/sub/mul/div/sqrt/rsqrt/min/max/abs is one operation (an FMA
# two), compares and selects are free.
OPS_PVAJ = 3 + 3 * (10 + 8 + 6)      # local time + Horner pos/vel/acc, 3 axes
OPS_POSE = 50                        # quadrotor tilt → R (pose_at)
OPS_REL = 18                         # Rᵀ(p − x)
OPS_CAND = 4                         # t + w·off, clip to [0, total]
OPS_PLATEAU = 22                     # min, tie band, run mean, window shrink
OPS_POSED = 18                       # poly_params pose transform
# body SDFs by kind id (isdf_torch/shapes/spec.py), counted from the device
# functions; where a function branches, its cheapest branch (a lower bound);
# cos, sin, atan2, floor and sqrt count one each
OPS_SDF = {
    1: 8,     # Ball: n3 (3 mul, 3 add, sqrt) + sub
    2: 12,    # RoundedCone
    3: 49,    # CappedCone
    4: 12,    # Torus: two n2 (5) + 2 sub
    5: 17,    # Cappedtorus: abs, 2 compare products, 3 (linear branch), psq 5,
              #   6 for the root
    6: 62,    # WireframeBox: 18 for ps/q, 3 × 14 for g, 2 min
    7: 44,    # BendLinear: t 11, ease 2 (first branch), shift 6, capsule 25
    8: 29,    # TwistBox: k·z, cos, sin, rotation 6, box 20
    9: 29,    # BendBox
    10: 49,   # Table: 2 abs, 6 sub, 2 boxes, min
    11: 83,   # Blobby: 4 balls (11) + 3 smooth unions (13)
    12: 47,   # Trefoil
    13: 41,   # SmoothDifference/SmoothIntersection: box 20, ball 8, blend 13
    14: 51,   # CSG: ball 8, box 20, 3 cylinders (6), 2 min, 2 max, neg
    15: 20,   # Box
    16: 7,    # Point
}


def sdf_ops(shape) -> int:
    return OPS_SDF[shape.spec.kind] + (OPS_POSED if shape.spec.posed else 0)


def k1_ops_per_query(shape, coarse_n: int, rounds: int, k: int = 8) -> int:
    sdf = sdf_ops(shape)
    scan = coarse_n * (OPS_REL + sdf)
    zooms = 2 * rounds * (k * (OPS_CAND + OPS_PVAJ + OPS_POSE + OPS_REL + sdf)
                          + OPS_PLATEAU)
    epilogue = OPS_PVAJ + OPS_POSE + OPS_REL + 4 * sdf   # dual: value + 3
    return scan + zooms + epilogue + 3


def k4_ops_per_query(shape, rounds: int, k: int = 8) -> int:
    return rounds * (k * (OPS_CAND + OPS_PVAJ + OPS_POSE + OPS_REL
                          + sdf_ops(shape)) + OPS_PLATEAU)


def bound_ms(ops: int, nbytes: int):
    """(bound ms, "operations" or "bytes", ops, bytes): the larger of the
    FP32 work over the FP32 non-tensor peak and the bytes (each input read
    once, each output written once) over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def k1_bound_ms(shape, P: int, N: int, coarse_n: int, rounds: int,
                B: int = 1):
    """K1's bound, and K2's with B scenarios: the same work per query, and
    every scenario's own pose table and piece tables read once."""
    ops = B * P * k1_ops_per_query(shape, coarse_n, rounds)
    nbytes = B * (4 * (P * (3 + 1) + coarse_n * 12 + N * (2 + 18))
                  + 4 * P * 5)
    return bound_ms(ops, nbytes)


def k4_bound_ms(shape, P: int, N: int, rounds: int):
    return bound_ms(P * k4_ops_per_query(shape, rounds),
                    4 * (P * (3 + 2) + N * (2 + 18)) + 4 * P)


# K3 operation count, per query point, read off isdf_torch/csrc/grid_sweep.cu
# the same way: a trilinear evaluation is grid coordinates (6), the clamp,
# corner index and fraction per axis (12), 3 weights and 7 lerps (24), the
# outside term (over 12, squares 5, root 4) and the sum (1)
OPS_COORD = 6
OPS_TRI = 12 + 3 + 21 + 12 + 5 + 4 + 1
OPS_TRI_GRAD = 33        # corner differences, lerps, masks, slope, 3 × 4
OPS_PLATEAU4 = 13        # k = 4: min 3, tie band 4, run mean 5, shrink 1
K3_PRE = 2               # warm pre-zoom rounds


def k3_ops_per_query(coarse_n: int, rounds: int, k: int = 4) -> int:
    pose = OPS_PVAJ + OPS_POSE + OPS_REL + OPS_COORD + OPS_TRI
    scan = coarse_n * (3 + pose)              # time j·step clipped, pose, SDF
    zooms = (K3_PRE + rounds) * (k * (OPS_CAND + pose) + OPS_PLATEAU4)
    return scan + zooms + pose + (pose + OPS_TRI_GRAD) + 3


def k3_bound_ms(grid, P: int, N: int, coarse_n: int, rounds: int,
                B: int = 1):
    """K3's bound: the operations of B·P queries; the bytes of the field and
    its pooled twin read once and of every scenario's points, warm starts,
    piece tables and results."""
    ops = B * P * k3_ops_per_query(coarse_n, rounds)
    nbytes = (4 * (grid.field.numel() + grid.pooled.numel())
              + B * (4 * (P * (3 + 1) + N * (2 + 18)) + 4 * P * 5))
    return bound_ms(ops, nbytes)


# ---------------------------------------------------------------------------
def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_inputs(torch, traj, params, pts, t_warm, coarse_n):
    from isdf_torch.sweep.sweep_sdf import traj_states

    total = traj.total_duration
    ts = torch.linspace(0.0, 1.0, coarse_n, device=pts.device) * total
    xs, Rs = traj_states(traj, params, ts)
    pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1).contiguous()
    durs = traj.durations.contiguous()
    starts = (torch.cumsum(durs, 0) - durs).contiguous()
    return (pts.contiguous(), t_warm.contiguous(), pose, starts, durs,
            traj.coeffs.contiguous())


def phase_kernels(dev):
    """K1 against sweep_warm_fused_ref on the card → (per-case records, the
    slice's (trajectory, points, warm starts))."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl, minco
    from isdf_torch.core.poly import PolyTraj
    from isdf_torch.shapes import SHAPE_REGISTRY, make_shape

    rng = np.random.default_rng(0)
    # the slice's size: a demo-scale path (12 pieces from START to GOAL),
    # P = max_obstacle_points voxels around it, coarse_n = 128, rounds = 24
    N = 12
    line = np.linspace(START, GOAL, N + 1)[1:-1]
    q = line + rng.normal(scale=1.0, size=line.shape)
    tail = np.zeros((3, 3))
    tail[:, 0] = GOAL
    head0 = np.zeros((3, 3))
    head0[:, 0] = START
    slice_traj = (q, rng.uniform(2.0, 3.0, size=N), tail)
    slice_pts = (np.linspace(START, GOAL, 4096)
                 + rng.uniform(-4.0, 4.0, size=(4096, 3)))
    # the JAX bench's size (bench.py:69-91): N = 6, P = 32768, coarse 64,
    # rounds 12
    Nb = 6
    qb = (np.linspace(1, 9, Nb - 1)[:, None] * np.array([1.0, 0.3, 0.15])
          + rng.normal(scale=0.3, size=(Nb - 1, 3)))
    tb = rng.uniform(1.2, 2.2, size=Nb)
    tailb = np.zeros((3, 3))
    tailb[:, 0] = [10.0, 3.0, 1.5]
    bench_pts = rng.uniform(-1, 11, size=(32768, 3))

    # the audit (manager._audit_sdf → sweep_sdf): the slice's trajectory and
    # points, cold (t_warm = 0), rounds 24, coarse_n duration-adaptive: 256 as
    # on the demo-1 plan, and 2048, its cap (a 96 KB pose table)
    sizes = [
        ("slice", slice_traj, slice_pts, 128, 24, head0, False),
        ("bench", (qb, tb, tailb), bench_pts, 64, 12, np.zeros((3, 3)),
         False),
        ("audit256", slice_traj, slice_pts, 256, 24, head0, True),
        ("audit2048", slice_traj, slice_pts, 2048, 24, head0, True),
    ]
    shapes = [
        ("RoundedCone", Config(**DEMO1)),
        ("Ball", Config()),
        ("CappedCone", Config()),
    ]
    records = []
    slice_case = None
    for (size_name, (qq, TT, tl), pts_np, coarse_n, rounds, head,
         cold) in sizes:
        f32 = dict(dtype=torch.float32, device=dev)
        T = torch.as_tensor(TT, **f32)
        coeffs = minco.solve(torch.as_tensor(qq, **f32), T,
                             torch.as_tensor(head, **f32),
                             torch.as_tensor(tl, **f32))
        traj = PolyTraj(T, coeffs)
        pts = torch.as_tensor(pts_np, **f32)
        if cold:
            t_warm = torch.zeros(len(pts_np), **f32)
        else:
            t_warm = torch.as_tensor(
                rng.uniform(0, float(T.sum()), size=len(pts_np)), **f32)
        if size_name == "slice":
            slice_case = (traj, pts, t_warm)
        cases = [(name, conf, 10) for name, conf in shapes]
        if size_name == "slice":
            # the other 17 zoo shapes, at the slice's size (fewer timing
            # runs of the plain version: it takes ~0.1 s a run)
            cases += [(name, Config(), 3) for name in SHAPE_REGISTRY
                      if name not in dict(shapes)]
        for shape_name, conf, plain_reps in cases:
            shape = make_shape(shape_name, conf)
            params = fl.FlatParams.from_config(conf)
            args = kernel_inputs(torch, traj, params, pts, t_warm, coarse_n)
            kw = dict(coarse_n=coarse_n, rounds=rounds, warm_window=0.3)
            records.append(hold_k1(shape, params, args, kw, size_name,
                                   plain_reps))
    return records, slice_case


def in_bands(what, tk, dk, gk, tr, dr, gr):
    """The sweep kernels' check against a plain version: finite results, d*
    in its band everywhere, t* equal on ≥ T_SHARE of the points and the
    gradient in its band there → (max |Δd*|, share, max |Δgrad|, checks)."""
    import torch

    for name, v in (("t*", tk), ("d*", dk), ("grad", gk)):
        check(bool(torch.isfinite(v).all()), f"{what}: non-finite {name}")
    dd = (dk - dr).abs()
    d_ok = bool((dd <= D_ATOL + D_RTOL * dr.abs()).all())
    agree = (tk - tr).abs() < T_AGREE
    share = float(agree.float().mean())
    g_err = float((gk - gr).abs()[agree].max()) if agree.any() else 0.0
    checks = [
        (d_ok, f"{what}: |Δd*| {float(dd.max()):.3g} outside the band"),
        (share >= T_SHARE, f"{what}: only {share:.4f} of points agree on t*"),
        (g_err <= G_ATOL, f"{what}: |Δgrad| {g_err:.3g} > {G_ATOL}"),
    ]
    return float(dd.max()), share, g_err, checks


def hold_k1(shape, params, args, kw, size_name, plain_reps: int = 10):
    """One K1 case against sweep_warm_fused_ref on the card → its record."""
    import torch
    from isdf_torch.sweep import fused_zoom

    pts, durs = args[0], args[4]
    what = f"K1 {shape.name}/{size_name}"
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args, **kw)
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args, **kw)
    torch.cuda.synchronize()
    max_d, share, g_err, checks = in_bands(what, tk, dk, gk, tr, dr, gr)
    ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused(
        shape, params, *args, **kw))
    plain_ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused_ref(
        shape, params, *args, **kw), warmup=1, reps=plain_reps)
    bound, bound_by, ops, nbytes = k1_bound_ms(
        shape, pts.shape[0], durs.shape[0], kw["coarse_n"], kw["rounds"])
    rec = dict(size=size_name, shape=shape.name, P=pts.shape[0],
               N=durs.shape[0], coarse_n=kw["coarse_n"], rounds=kw["rounds"],
               max_abs_d=max_d, t_share=share, max_abs_grad=g_err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, ops=ops,
               bytes=nbytes)
    print("K1 vs plain " + json.dumps(rec), flush=True)
    for ok, msg in checks:
        check_kernel(ok, msg)
    return rec


# the scenario-batched back end at the width the JAX bench runs it
# (bench.py:69-72,151-190)
BATCH_CONF = dict(integralIntervs=32, sweep_coarse_samples=64,
                  sweep_refine_rounds=12, vmax=5.0, omgmax=5.0, thetamax=1.5,
                  safety_hor=0.4, mem_size=8)
BATCH_N, BATCH_P, BATCH_ITERS, BATCH_CHUNK = 4, 512, 24, 8
AUDIT_COARSE_N = 512    # batched_solve_audited's audit_coarse_n
COST_RISE = 1e-3    # band of a final cost above its scenario's first cost
ALONE_RTOL = 1e-4   # band of a scenario solved alone against it in a batch


def batched_kernel_inputs(torch, shape_name, B, dev, seed, coarse_n=None,
                          cold=False):
    """K2's inputs as the batched solve gives them: make_random_batch's
    points and start trajectories (durations varied per scenario and piece,
    as they are after a few iterations), random warm starts; with ``cold``
    as the batched audit gives them (t_warm = 0, its own coarse_n)."""
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl, minco
    from isdf_torch.core.poly import PolyTraj
    from isdf_torch.parallel import batch as pb
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep.sweep_sdf import traj_states

    conf = Config(**BATCH_CONF)
    shape = make_shape(shape_name, conf)
    params = fl.FlatParams.from_config(conf)
    sb = pb.make_random_batch(conf, B, N=BATCH_N, n_points=BATCH_P,
                              seed=seed, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    T = sb.T0 * (0.6 + 0.8 * torch.rand(sb.T0.shape, generator=gen)).to(dev)
    traj = PolyTraj(T, minco.solve(sb.q0, T, sb.head, sb.tail))
    coarse_n = coarse_n or conf.sweep_coarse_samples
    ts = torch.linspace(0.0, 1.0, coarse_n, device=dev) \
        * traj.total_duration[:, None]
    xs, Rs = traj_states(traj, params, ts)
    pose = torch.cat([xs, Rs.flatten(-2)], dim=-1).contiguous()
    t_warm = (torch.rand(sb.mask.shape, generator=gen).to(dev)
              * traj.total_duration[:, None]).contiguous()
    if cold:
        t_warm = torch.zeros_like(t_warm)
    starts = (torch.cumsum(T, -1) - T).contiguous()
    kw = dict(coarse_n=coarse_n, rounds=conf.sweep_refine_rounds,
              warm_window=0.3)
    return shape, params, (sb.points.contiguous(), t_warm, pose, starts,
                           T.contiguous(), traj.coeffs.contiguous()), kw


def phase_k2(dev):
    """K2 against its plain version and against per-scenario K1 launches at
    B = 64, then against its plain version and timed at the three shapes the
    batched solves launch it at → records."""
    import torch
    from isdf_torch.sweep import fused_zoom

    records = []
    for shape_name in ("CappedCone", "CSG", "Trefoil"):
        shape, params, args, kw = batched_kernel_inputs(
            torch, shape_name, 64, dev, seed=1)
        what = f"K2 {shape_name}/B64"
        tk, dk, gk = fused_zoom.sweep_warm_fused_batched(
            shape, params, *args, **kw)
        tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(
            shape, params, *args, **kw)
        per = [fused_zoom.sweep_warm_fused(
            shape, params, *(a[b] for a in args), **kw) for b in range(64)]
        torch.cuda.synchronize()
        t1, d1, g1 = (torch.stack(o) for o in zip(*per))
        same = bool(torch.equal(tk, t1) and torch.equal(dk, d1)
                    and torch.equal(gk, g1))
        max_d, share, g_err, checks = in_bands(what, tk, dk, gk, tr, dr, gr)
        rec = dict(shape=shape_name, B=64, P=BATCH_P, N=BATCH_N,
                   max_abs_d=max_d, t_share=share, max_abs_grad=g_err,
                   equals_per_scenario_k1=same)
        records.append(rec)
        print("K2 vs plain " + json.dumps(rec), flush=True)
        check_kernel(same, f"{what}: differs from K1 launched per scenario")
        for ok, msg in checks:
            check_kernel(ok, msg)
    # the shapes the batched solve launches K2 at: the warm sweep of a cost
    # evaluation at B = 128 and B = 4096, and the audited solve's cold sweep
    # (t_warm = 0, audit_coarse_n = 512: a 24 KB pose table per scenario,
    # read from global memory) at B = 128
    for label, B, coarse_n, cold in (("B128", 128, None, False),
                                     ("B128/audit", 128, AUDIT_COARSE_N, True),
                                     ("B4096", 4096, None, False)):
        shape, params, args, kw = batched_kernel_inputs(
            torch, "CappedCone", B, dev, seed=2, coarse_n=coarse_n, cold=cold)
        what = f"K2 CappedCone/{label}"
        tk, dk, gk = fused_zoom.sweep_warm_fused_batched(
            shape, params, *args, **kw)
        ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused_batched(
            shape, params, *args, **kw))
        # the plain version is a loop over the scenarios (~50 ms each): one
        # timed run of all of them at B = 128, whose results are the ones
        # compared; at B = 4096 the first, the last and three scenarios
        # between, each through the single-scenario plain version
        if B == 128:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(
                shape, params, *args, **kw)
            b.record()
            b.synchronize()
            plain_ms, rows = a.elapsed_time(b), slice(None)
        else:
            rows = [0, B // 4, B // 2, 3 * B // 4, B - 1]
            per = [fused_zoom.sweep_warm_fused_ref(
                shape, params, *(x[i] for x in args), **kw) for i in rows]
            tr, dr, gr = (torch.stack(o) for o in zip(*per))
            plain_ms = None
        torch.cuda.synchronize()
        max_d, share, g_err, checks = in_bands(
            what, tk[rows], dk[rows], gk[rows], tr, dr, gr)
        bound, bound_by, ops, nbytes = k1_bound_ms(
            shape, BATCH_P, BATCH_N, kw["coarse_n"], kw["rounds"], B=B)
        rec = dict(shape="CappedCone", case=label, B=B, P=BATCH_P, N=BATCH_N,
                   coarse_n=kw["coarse_n"], rounds=kw["rounds"], cold=cold,
                   compared_scenarios=len(tr), max_abs_d=max_d,
                   t_share=share, max_abs_grad=g_err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   ops=ops, bytes=nbytes)
        records.append(rec)
        print("K2 vs plain, timed " + json.dumps(rec), flush=True)
        for ok, msg in checks:
            check_kernel(ok, msg)
    return records


def phase_k4(dev, slice_case):
    """K4 against zoom_refine_ref at the slice's size (the K1 slice's
    trajectory and points, rounds 12, windows 0.05–1 s): t* equal on
    ≥ T_SHARE of the points, and the SDF at the two t* in d*'s band."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.sweep.fast_eval import sdf_at_time_c

    traj, pts, t_warm = slice_case
    gen = torch.Generator(device="cpu").manual_seed(4)
    w0 = (0.05 + 0.95 * torch.rand(pts.shape[0], generator=gen)).to(dev)
    durs = traj.durations.contiguous()
    starts = (torch.cumsum(durs, 0) - durs).contiguous()
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    records = []
    for shape_name, conf in (("RoundedCone", Config(**DEMO1)),
                             ("CappedCone", Config()), ("CSG", Config())):
        shape = make_shape(shape_name, conf)
        params = fl.FlatParams.from_config(conf)
        args = (pts.contiguous(), t_warm.contiguous(), w0, starts, durs,
                traj.coeffs.contiguous())
        tk = fused_zoom.zoom_refine(shape, params, *args, rounds=12)
        tr = fused_zoom.zoom_refine_ref(shape, params, *args, rounds=12)
        with torch.no_grad():
            dk = sdf_at_time_c(shape, traj, params, pw, tk)
            dr = sdf_at_time_c(shape, traj, params, pw, tr)
        torch.cuda.synchronize()
        what = f"K4 {shape_name}/slice"
        check(bool(torch.isfinite(tk).all()), f"{what}: non-finite t*")
        share = float(((tk - tr).abs() < T_AGREE).float().mean())
        dd = (dk - dr).abs()
        ms = cuda_ms(lambda: fused_zoom.zoom_refine(
            shape, params, *args, rounds=12))
        plain_ms = cuda_ms(lambda: fused_zoom.zoom_refine_ref(
            shape, params, *args, rounds=12), warmup=1, reps=5)
        bound, bound_by, ops, nbytes = k4_bound_ms(
            shape, pts.shape[0], durs.shape[0], 12)
        rec = dict(shape=shape_name, P=pts.shape[0], N=durs.shape[0],
                   rounds=12, t_share=share, max_abs_d=float(dd.max()),
                   max_abs_t=float((tk - tr).abs().max()), ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   ops=ops, bytes=nbytes)
        records.append(rec)
        print("K4 vs plain " + json.dumps(rec), flush=True)
        check_kernel(share >= T_SHARE,
                     f"{what}: only {share:.4f} of points agree on t*")
        check_kernel(bool((dd <= D_ATOL + D_RTOL * dr.abs()).all()),
                     f"{what}: SDF at t* differs by {float(dd.max()):.3g}")
    return records


# the mesh robot's slice: demo 6 (isdf_tpu/demos.py:31-59 _COMMON and
# :139-149) with its Lthick.obj replaced by a synthetic thick L (the
# reference's mesh assets are not in the repo), baked at selfmapresu; its
# procedural map3 (three slit walls); start (5, 5, 5), goal (40, 5, 5)
DEMO6 = dict(DEMO1, poly_params=(0.0,) * 6, kernel_size=17, safety_hor=0.6)
START6, GOAL6 = (5.0, 5.0, 5.0), (40.0, 5.0, 5.0)


def write_l_robot(dirpath: str) -> str:
    """The stand-in body as an OBJ file → its path: an L of arms 1.6 m (x)
    and 1.0 m (y), 0.3 m thick, 20 outward triangles (shapes/mesh.l_prism)."""
    from isdf_torch.shapes import mesh as meshlib

    path = os.path.join(dirpath, "Lthick.obj")
    meshlib.write_obj(path, *meshlib.l_prism())
    return path


def torus_grid(torch, n: int, res: float, dev):
    """The JAX bench's torus field (bench.py:198-205: ring 0.6, tube 0.25)
    on an n³ grid of spacing res centred on the origin → GridField."""
    from isdf_torch.sweep.grid_zoom import GridField

    origin = -0.5 * n * res
    ax = origin + torch.arange(n, dtype=torch.float64, device=dev) * res
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    xy = torch.sqrt(x * x + y * y) - 0.6
    return GridField.build(torch.sqrt(xy * xy + z * z) - 0.25,
                           (origin,) * 3, res, dev)


def hold_k3(grid, params, args, kw, label, plain_reps: int = 10,
            batched: bool = False):
    """One K3 case against its plain version on the card → its record."""
    import torch
    from isdf_torch.sweep import grid_zoom

    kern, plain = ((grid_zoom.grid_sweep_warm_fused_batched,
                    grid_zoom.grid_sweep_warm_fused_batched_ref) if batched
                   else (grid_zoom.grid_sweep_warm_fused,
                         grid_zoom.grid_sweep_warm_fused_ref))
    pts, durs = args[0], args[3]
    what = f"K3 {label}"
    tk, dk, gk = kern(grid, params, *args, **kw)
    tr, dr, gr = plain(grid, params, *args, **kw)
    torch.cuda.synchronize()
    max_d, share, g_err, checks = in_bands(what, tk, dk, gk, tr, dr, gr)
    ms = cuda_ms(lambda: kern(grid, params, *args, **kw))
    plain_ms = cuda_ms(lambda: plain(grid, params, *args, **kw), warmup=1,
                       reps=plain_reps)
    B = pts.shape[0] if batched else 1
    P = pts.shape[-2]
    bound, bound_by, ops, nbytes = k3_bound_ms(
        grid, P, durs.shape[-1], kw["coarse_n"], kw["rounds"], B=B)
    rec = dict(case=label, field=list(grid.dims), B=B, P=P,
               N=durs.shape[-1], coarse_n=kw["coarse_n"],
               rounds=kw["rounds"], cold=bool((args[1] == 0).all()),
               max_abs_d=max_d, t_share=share, max_abs_grad=g_err,
               t_equal=float((tk == tr).float().mean()),
               d_equal=float((dk == dr).float().mean()),
               grad_equal=float((gk == gr).float().mean()),
               max_abs_t=float((tk - tr).abs().max()), ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, ops=ops,
               bytes=nbytes)
    print("K3 vs plain " + json.dumps(rec), flush=True)
    for ok, msg in checks:
        check_kernel(ok, msg)
    return rec


def phase_k3(dev, obj_path):
    """K3 against grid_sweep_warm_fused_ref: the L robot's field at the mesh
    slice's size (warm) and the audit's (cold, coarse 256 and 2048), the JAX
    bench's grid case (64³ torus at 0.04 m, P = 32,768, N = 6, coarse 64,
    rounds 12), a 192³ field (28 MB in float32, past the TPU kernel's 8 MiB
    budget) on the slice's points, and batched at B = 64 × P = 512, also
    bit for bit against K3 launched per scenario → records."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl, minco
    from isdf_torch.shapes import shape_from_config
    from isdf_torch.sweep import grid_zoom

    conf = Config(**DEMO6, inputdata=obj_path)
    grid = shape_from_config(conf, device=dev).grid
    params = fl.FlatParams.from_config(conf)
    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)

    def traj_args(N, start, goal, T, pts_np, cold, q=None):
        head = np.zeros((3, 3))
        head[:, 0] = start
        tail = np.zeros((3, 3))
        tail[:, 0] = goal
        if q is None:
            line = np.linspace(start, goal, N + 1)[1:-1]
            q = line + rng.normal(scale=1.0, size=line.shape)
        Tt = torch.as_tensor(T, **f32)
        coeffs = minco.solve(torch.as_tensor(q, **f32), Tt,
                             torch.as_tensor(head, **f32),
                             torch.as_tensor(tail, **f32))
        P = len(pts_np)
        tw = (torch.zeros(P, **f32) if cold else torch.as_tensor(
            rng.uniform(0, float(Tt.sum()), size=P), **f32))
        return (torch.as_tensor(pts_np, **f32), tw,
                (torch.cumsum(Tt, 0) - Tt).contiguous(), Tt.contiguous(),
                coeffs.contiguous())

    # the mesh slice: 12 pieces from START6 to GOAL6, P = max_obstacle_points
    # voxels within 2 m of the path
    N = 12
    T = rng.uniform(2.0, 3.0, size=N)
    line = np.linspace(START6, GOAL6, N + 1)[1:-1]
    q = line + rng.normal(scale=1.0, size=line.shape)
    pts = (np.linspace(START6, GOAL6, 4096)
           + rng.uniform(-2.0, 2.0, size=(4096, 3)))
    warm = traj_args(N, START6, GOAL6, T, pts, False, q)
    cold = (warm[0], torch.zeros_like(warm[1])) + warm[2:]
    # the JAX bench's grid case (bench.py:69-91,195-219)
    Nb = 6
    qb = (np.linspace(1, 9, Nb - 1)[:, None] * np.array([1.0, 0.3, 0.15])
          + rng.normal(scale=0.3, size=(Nb - 1, 3)))
    bench = traj_args(Nb, (0.0, 0.0, 0.0), (10.0, 3.0, 1.5),
                      rng.uniform(1.2, 2.2, size=Nb),
                      rng.uniform(-1, 11, size=(32768, 3)), False, qb)
    records = []
    for label, g, args, coarse_n, rounds in (
            ("L/slice", grid, warm, 128, 24),
            ("L/audit256", grid, cold, 256, 24),
            ("L/audit2048", grid, cold, 2048, 24),
            ("torus64/bench", torus_grid(torch, 64, 0.04, dev), bench, 64,
             12),
            ("torus192/slice", torus_grid(torch, 192, 2.56 / 192, dev), warm,
             128, 24)):
        kw = dict(coarse_n=coarse_n, rounds=rounds, warm_window=0.3)
        records.append(hold_k3(g, params, args, kw, label,
                               plain_reps=3 if coarse_n > 256 else 10))
    # batched: make_random_batch's scenarios as K2's phase draws them
    _, bparams, bargs, kw = batched_kernel_inputs(torch, "CappedCone", 64,
                                                  dev, seed=1)
    bargs = tuple(a for i, a in enumerate(bargs) if i != 2)   # no pose table
    rec = hold_k3(grid, bparams, bargs, kw, "L/B64", plain_reps=1,
                  batched=True)
    tk, dk, gk = grid_zoom.grid_sweep_warm_fused_batched(grid, bparams,
                                                         *bargs, **kw)
    per = [grid_zoom.grid_sweep_warm_fused(
        grid, bparams, *(a[b] for a in bargs), **kw) for b in range(64)]
    torch.cuda.synchronize()
    t1, d1, g1 = (torch.stack(o) for o in zip(*per))
    rec["equals_per_scenario_k3"] = bool(
        torch.equal(tk, t1) and torch.equal(dk, d1) and torch.equal(gk, g1))
    print(f"K3 L/B64 equals K3 launched per scenario: "
          f"{rec['equals_per_scenario_k3']}", flush=True)
    check_kernel(rec["equals_per_scenario_k3"],
                 "K3 L/B64: differs from K3 launched per scenario")
    records.append(rec)
    return records


def phase_plan(dev):
    """PlannerManager.plan on the demo-1 scene → (metrics, K1 launches, the
    manager, the trajectory)."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.plan import PlannerManager
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.world import GridMap, maps_gen

    conf = Config(**DEMO1)
    t0 = time.perf_counter()
    pm = PlannerManager(conf, shape_name="RoundedCone", device=dev)
    cloud = maps_gen.map4(res=0.8, seed=0)
    gm = GridMap.from_points(cloud, None, conf.occupancy_resolution,
                             conf.sta_threshold, device=dev)
    pm.set_map(gm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"plan: map {tuple(gm.occ.shape)} voxels from {len(cloud)} points, "
          f"pose kernels {tuple(pm.pose_kernels.kernels.shape)}, set-up "
          f"{setup_s:.2f} s; back-end max_iters cap {MAX_ITERS}", flush=True)

    fused_zoom.LAUNCHES = 0
    t0 = time.perf_counter()
    res = pm.plan(np.asarray(START), np.asarray(GOAL), max_iters=MAX_ITERS)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches = fused_zoom.LAUNCHES

    m = res.metrics
    check(res.success, f"plan failed: {m}")
    cost = float(m["final_cost"])
    print(f"plan: success={res.success} n_pieces={m['n_pieces']} "
          f"mid_end iters={m['mid_end_iters']} evals={m['mid_end_evals']} "
          f"back_end iters={m['back_end_iters']} evals={m['back_end_evals']} "
          f"safety_replans={m.get('safety_replans', 0)}", flush=True)
    print(f"plan: final_cost={cost!r} total_duration="
          f"{m['total_duration']!r}", flush=True)
    phases = {k: m[k] for k in ("front_end_s", "aabb_s", "mid_end_s",
                                "back_end_s", "audit_s") if k in m}
    print("plan: seconds " + json.dumps(dict(phases, plan_s=plan_s,
                                             setup_s=setup_s)), flush=True)
    traj = res.traj
    check(math.isfinite(cost), f"non-finite final cost {cost}")
    check(tuple(traj.coeffs.shape) == (m["n_pieces"], 6, 3)
          and bool(torch.isfinite(traj.coeffs).all())
          and bool(torch.isfinite(traj.durations).all()),
          "trajectory has the wrong shape or non-finite entries")
    ends = traj.junction_positions()[[0, -1]].cpu().numpy()
    reach = 6 * np.sqrt(3) * conf.occupancy_resolution   # snap radius
    check(np.linalg.norm(ends[0] - START) <= reach
          and np.linalg.norm(ends[1] - GOAL) <= reach,
          f"trajectory ends {ends.tolist()} far from {START} → {GOAL}")
    min_sdf = pm.audit_collision(traj)
    print(f"plan: audit min swept SDF = {min_sdf!r}", flush=True)
    print(f"plan: K1 launches in the plan = {launches}", flush=True)
    check(launches > 0, "the plan never launched K1")
    return m, launches, pm, traj


def phase_refine(pm, traj) -> int:
    """K4 through its entry point, as a caller of ``zoom_refine`` uses it:
    the argmin times the audit found at every occupied voxel near the
    planned trajectory, refined once more in a ±0.05 s window.  The refined
    times must not sit at a shallower SDF than the audit's (beyond 5e-3 m:
    a plateau-centred pick may move along a plateau), and must agree with
    zoom_refine_ref on the same tensors as in phase_k4.  → K4 launches."""
    import torch
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.sweep.fast_eval import sdf_at_time_c

    live, sdf, t_star = pm._audit_sdf(traj)
    check(live is not None, "refine: no occupied voxel near the trajectory")
    f32 = dict(dtype=torch.float32, device=pm.device)
    pts = torch.as_tensor(live, **f32).contiguous()
    t0 = torch.as_tensor(t_star, **f32).contiguous()
    durs = traj.durations.detach().contiguous()
    fused_zoom.LAUNCHES_ZOOM = 0
    args = (pts, t0, torch.full_like(t0, 0.05),
            (torch.cumsum(durs, 0) - durs).contiguous(), durs,
            traj.coeffs.detach().contiguous())
    t_ref = fused_zoom.zoom_refine(pm.shape, pm.params, *args, rounds=12)
    torch.cuda.synchronize()
    launches = fused_zoom.LAUNCHES_ZOOM
    t_plain = fused_zoom.zoom_refine_ref(pm.shape, pm.params, *args,
                                         rounds=12)
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    with torch.no_grad():
        d_ref = sdf_at_time_c(pm.shape, traj.detach(), pm.params, pw, t_ref)
        d_plain = sdf_at_time_c(pm.shape, traj.detach(), pm.params, pw,
                                t_plain)
    rise = float((d_ref - torch.as_tensor(sdf, **f32)).max())
    share = float(((t_ref - t_plain).abs() < T_AGREE).float().mean())
    dd = (d_ref - d_plain).abs()
    print(f"refine: K4 on {len(live)} voxels, {launches} launch(es), "
          f"max |Δt*| = {float((t_ref - t0).abs().max())!r}, largest rise "
          f"of the SDF = {rise!r}; against its plain version: t* agrees on "
          f"{share!r} of the voxels, max |ΔSDF at t*| = {float(dd.max())!r}",
          flush=True)
    check(bool(torch.isfinite(t_ref).all()), "refine: non-finite t*")
    check(rise <= 5e-3, f"refine: the SDF rose by {rise:.3g}")
    check(share >= T_SHARE,
          f"refine: only {share:.4f} of voxels agree with the plain t*")
    check(bool((dd <= D_ATOL + D_RTOL * d_plain.abs()).all()),
          f"refine: SDF at t* differs from the plain version's by "
          f"{float(dd.max()):.3g}")
    check(launches > 0, "refine never launched K4")
    return launches


def device_busy(prof, wall: float, kernel_word: str) -> dict:
    """Union of the device intervals a torch.profiler run recorded → the
    device's busy share of `wall`, and the time in kernels whose name holds
    `kernel_word`."""
    import torch

    spans, k_ns = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        if kernel_word in e.name():
            k_ns += e.end_ns() - e.start_ns()
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        return {}
    return dict(wall_s=wall, device_events=len(spans),
                device_busy_s=busy * 1e-9, busy_share=busy * 1e-9 / wall,
                sweep_kernel_s=k_ns * 1e-9)


def phase_profile(pm, batch_case, pm_mesh) -> None:
    """``--profile``: one more demo-1 plan (warm: A* already built), one
    more B = 4096 batched solve and one more mesh plan, each under
    torch.profiler tracing the card only → the device's busy share of each
    one's wall time, and the sweep kernel's part of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from isdf_torch.parallel import batch as pb

    shape, conf, sb = batch_case
    runs = (
        ("plan", lambda: pm.plan(np.asarray(START), np.asarray(GOAL),
                                 max_iters=MAX_ITERS)),
        ("batch B=4096", lambda: pb.batched_solve_chunked(
            shape, conf, sb, max_iters=BATCH_ITERS, chunk=BATCH_CHUNK)),
        ("mesh plan", lambda: pm_mesh.plan(np.asarray(START6),
                                           np.asarray(GOAL6),
                                           max_iters=MAX_ITERS)),
    )
    for label, run in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = device_busy(prof, wall, "grid_sweep" if label == "mesh plan"
                          else "sweep_warm")
        if not got:
            print(f"profile {label}: the profiler recorded no device events;"
                  " device busy share not measured", flush=True)
        else:
            print(f"profile {label}: " + json.dumps(got), flush=True)


def phase_batch(dev):
    """The scenario-batched back end on the card → (K2 launches of the
    B = 128 solve, the B = 4096 case for ``--profile``)."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.parallel import batch as pb
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom

    conf = Config(**BATCH_CONF)
    shape = make_shape("CappedCone", conf)
    trips = 2 * BATCH_CHUNK + 8          # loop trips per chunk, 2 evals each
    launches_main, big_case, small = None, None, None

    def solve(sb, **kw):
        chunks = [1]

        def between(res):
            chunks[0] += not bool(res.converged.all())

        out = pb.batched_solve_chunked(
            shape, conf, sb, max_iters=BATCH_ITERS, chunk=BATCH_CHUNK,
            callback=between, **kw)
        torch.cuda.synchronize()
        return out, chunks[0]

    for B in (128, 4096):
        sb = pb.make_random_batch(conf, B, N=BATCH_N, n_points=BATCH_P,
                                  seed=0)
        f0, g0 = pb.batched_cost_and_grad(shape, conf, sb)
        solve(sb)                                          # warm call
        walls = []
        for _ in range(3):
            fused_zoom.LAUNCHES_BATCHED = 0
            t0 = time.perf_counter()
            (coeffs, T, costs, iters), n_chunks = solve(sb)
            walls.append(time.perf_counter() - t0)
            launches = fused_zoom.LAUNCHES_BATCHED
        wall = statistics.median(walls)
        what = f"batch B={B}"
        check(tuple(coeffs.shape) == (B, BATCH_N, 6, 3)
              and tuple(T.shape) == (B, BATCH_N),
              f"{what}: wrong output shapes")
        for name, v in (("coeffs", coeffs), ("T", T), ("costs", costs),
                        ("first costs", f0), ("first gradient", g0)):
            check(bool(torch.isfinite(v).all()), f"{what}: non-finite {name}")
        check(bool((T > 0).all()), f"{what}: non-positive durations")
        # A scenario's reported cost is its baseline under the warm t* seeds,
        # its first cost the cold evaluation.  The warm sweep also zooms
        # around the last t* and can find a deeper minimum than the cold one,
        # so a scenario whose first line search fails (no accepted step: the
        # halve/double schedule has no bracket and can cycle) ends at the
        # refreshed baseline, a little above its first cost (measured: 3 of
        # 128 scenarios, 5e-6 of the cost).  Band: 1e-3 of the first cost
        # (the largest rise measured at B = 4096 is 1e-4);
        # the batch as a whole must descend.
        ratio = costs / f0
        stuck = int((iters == 0).sum())
        check(bool((ratio <= 1.0 + COST_RISE).all()),
              f"{what}: {int((ratio > 1.0 + COST_RISE).sum())} scenarios "
              f"ended more than {COST_RISE} above their first cost")
        check(float(ratio.median()) < 0.9,
              f"{what}: the median cost fell only to "
              f"{float(ratio.median()):.3f} of the first")
        # the lockstep schedule: one first evaluation, then per chunk
        # 2·chunk + 8 loop trips of two evaluations, one K2 launch each
        expect = 1 + 2 * trips * n_chunks
        check(launches == expect, f"{what}: {launches} K2 launches, the "
                                  f"lockstep schedule implies {expect}")
        rec = dict(B=B, N=BATCH_N, P=BATCH_P, max_iters=BATCH_ITERS,
                   chunk=BATCH_CHUNK, chunks=n_chunks,
                   loop_trips=trips * n_chunks, k2_launches=launches,
                   wall_s=wall, walls_s=walls, plans_per_s=B / wall,
                   accepted_steps_mean=float(iters.float().mean()),
                   no_accepted_step=stuck,
                   above_first_cost=int((ratio > 1.0).sum()),
                   cost_ratio_max=float(ratio.max()),
                   cost_first_median=float(f0.median()),
                   cost_final_median=float(costs.median()))
        print("batch " + json.dumps(rec), flush=True)
        if B == 128:
            launches_main, small = launches, (sb, costs)
        else:
            big_case = (shape, conf, sb)

    # a scenario's result does not depend on its neighbours: scenarios 0–3
    # of the B = 128 batch solved alone as a B = 4 batch.  Not bitwise: the
    # library's reductions and batched LU round differently at another
    # batch size.  The band is 1e-4 of the cost (measured: ≤ 7.6e-7 on an
    # H100 at 700 W), tight enough that a scenario reading a neighbour's
    # pose table or durations would leave it.
    sb, costs = small
    sb4 = pb.ScenarioBatch(*(getattr(sb, n)[:4] for n in (
        "head", "tail", "q0", "T0", "points", "mask")))
    (_, _, costs4, _), _ = solve(sb4)
    rel = ((costs4 - costs[:4]).abs() / costs[:4].abs()).tolist()
    print("batch B=4 against scenarios 0-3 of B=128: costs "
          + json.dumps(dict(alone=costs4.tolist(), in_batch=costs[:4].tolist(),
                            rel_diff=rel)), flush=True)
    check(max(rel) <= ALONE_RTOL, f"batch: scenarios solved alone differ "
                                  f"by {max(rel):.3g} of their cost")

    sba = pb.make_random_batch(conf, 128, N=BATCH_N, n_points=BATCH_P, seed=3)
    fused_zoom.LAUNCHES_BATCHED = 0
    t0 = time.perf_counter()
    coeffs, T, costs, iters, audit = pb.batched_solve_audited(
        shape, conf, sba, max_iters=BATCH_ITERS, chunk=BATCH_CHUNK,
        audit_coarse_n=AUDIT_COARSE_N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, v in (("coeffs", coeffs), ("T", T), ("costs", costs)):
        check(bool(torch.isfinite(v).all()), f"audited: non-finite {name}")
    check(bool(np.isfinite(audit["min_sdf"]).all()),
          "audited: non-finite min SDF")
    hist = audit["violations_per_round"]
    print("batch audited " + json.dumps(dict(
        B=128, wall_s=wall, plans_per_s=128 / wall,
        k2_launches=fused_zoom.LAUNCHES_BATCHED,
        violations_per_round=hist, last_violations=hist[-1],
        min_sdf_min=float(audit["min_sdf"].min()),
        min_sdf_median=float(np.median(audit["min_sdf"])),
        scenarios_clear=int((audit["min_sdf"] > 1e-3).sum()))), flush=True)
    check(fused_zoom.LAUNCHES_BATCHED > 0, "the audited solve never "
                                           "launched K2")
    return launches_main, big_case


def phase_mesh_plan(dev, obj_path):
    """PlannerManager.plan on the demo-6 scene with the L robot → (metrics,
    K3 launches, the manager).  K3 must launch once per back-end cost
    evaluation and once per audit sweep."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.plan import PlannerManager
    from isdf_torch.shapes import shape_from_config
    from isdf_torch.sweep import grid_zoom
    from isdf_torch.world import GridMap, maps_gen

    conf = Config(**DEMO6, inputdata=obj_path)
    t0 = time.perf_counter()
    shape = shape_from_config(conf, device=dev)
    pm = PlannerManager(conf, shape=shape, device=dev)
    cloud = maps_gen.map3(res=0.8, seed=0)
    gm = GridMap.from_points(cloud, None, conf.occupancy_resolution,
                             conf.sta_threshold, device=dev)
    pm.set_map(gm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"mesh plan: field {shape.grid.dims} (pooled "
          f"{shape.grid.pooled_dims}) at {conf.selfmapresu} m, map "
          f"{tuple(gm.occ.shape)} voxels from {len(cloud)} points, pose "
          f"kernels {tuple(pm.pose_kernels.kernels.shape)}, set-up "
          f"{setup_s:.2f} s; back-end max_iters cap {MAX_ITERS}", flush=True)

    grid_zoom.LAUNCHES_GRID = 0
    t0 = time.perf_counter()
    res = pm.plan(np.asarray(START6), np.asarray(GOAL6), max_iters=MAX_ITERS)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches = grid_zoom.LAUNCHES_GRID

    m = res.metrics
    check(res.success, f"mesh plan failed: {m}")
    cost = float(m["final_cost"])
    replans = m.get("safety_replans", 0)
    # an audit sweep before every re-solve, and one more unless the last
    # round's re-solve ended the loop
    audits = min(replans + 1, conf.safety_replan_rounds)
    print(f"mesh plan: success={res.success} n_pieces={m['n_pieces']} "
          f"mid_end iters={m['mid_end_iters']} evals={m['mid_end_evals']} "
          f"back_end iters={m['back_end_iters']} evals={m['back_end_evals']} "
          f"safety_replans={replans}", flush=True)
    print(f"mesh plan: final_cost={cost!r} total_duration="
          f"{m['total_duration']!r}", flush=True)
    phases = {k: m[k] for k in ("front_end_s", "aabb_s", "mid_end_s",
                                "back_end_s", "audit_s") if k in m}
    print("mesh plan: seconds " + json.dumps(dict(phases, plan_s=plan_s,
                                                  setup_s=setup_s)),
          flush=True)
    traj = res.traj
    check(math.isfinite(cost), f"mesh plan: non-finite final cost {cost}")
    check(bool(torch.isfinite(traj.coeffs).all())
          and bool(torch.isfinite(traj.durations).all()),
          "mesh plan: non-finite trajectory")
    ends = traj.junction_positions()[[0, -1]].cpu().numpy()
    reach = 6 * np.sqrt(3) * conf.occupancy_resolution   # snap radius
    check(np.linalg.norm(ends[0] - START6) <= reach
          and np.linalg.norm(ends[1] - GOAL6) <= reach,
          f"mesh plan: ends {ends.tolist()} far from {START6} → {GOAL6}")
    min_sdf = pm.audit_collision(traj)
    print(f"mesh plan: audit min swept SDF = {min_sdf!r}", flush=True)
    print(f"mesh plan: K3 launches in the plan = {launches} "
          f"({m['back_end_evals']} back-end evaluations + {audits} audit "
          f"sweeps)", flush=True)
    check(launches > 0, "the mesh plan never launched K3")
    check(launches == m["back_end_evals"] + audits,
          f"mesh plan: {launches} K3 launches, expected "
          f"{m['back_end_evals']} + {audits}")
    check(math.isfinite(min_sdf), "mesh plan: non-finite audit SDF")
    return m, launches, pm


def phase_mesh_batch(dev, shape):
    """batched_solve_chunked with the L robot at the bench's width (B = 128,
    N = 4, P = 512, max_iters = 24, chunk = 8) → its record."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.parallel import batch as pb
    from isdf_torch.sweep import grid_zoom

    conf = Config(**BATCH_CONF)
    B = 128
    trips = 2 * BATCH_CHUNK + 8
    sb = pb.make_random_batch(conf, B, N=BATCH_N, n_points=BATCH_P, seed=0)
    f0, g0 = pb.batched_cost_and_grad(shape, conf, sb)
    chunks = [1]

    def between(res):
        chunks[0] += not bool(res.converged.all())

    grid_zoom.LAUNCHES_GRID = 0
    t0 = time.perf_counter()
    coeffs, T, costs, iters = pb.batched_solve_chunked(
        shape, conf, sb, max_iters=BATCH_ITERS, chunk=BATCH_CHUNK,
        callback=between)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = grid_zoom.LAUNCHES_GRID
    what = "mesh batch B=128"
    for name, v in (("coeffs", coeffs), ("T", T), ("costs", costs),
                    ("first costs", f0), ("first gradient", g0)):
        check(bool(torch.isfinite(v).all()), f"{what}: non-finite {name}")
    ratio = costs / f0
    expect = 1 + 2 * trips * chunks[0]
    rec = dict(B=B, N=BATCH_N, P=BATCH_P, max_iters=BATCH_ITERS,
               chunk=BATCH_CHUNK, chunks=chunks[0],
               loop_trips=trips * chunks[0], k3_launches=launches,
               wall_s=wall, plans_per_s=B / wall,
               accepted_steps_mean=float(iters.float().mean()),
               no_accepted_step=int((iters == 0).sum()),
               cost_ratio_max=float(ratio.max()),
               cost_ratio_median=float(ratio.median()),
               cost_first_median=float(f0.median()),
               cost_final_median=float(costs.median()))
    print("mesh batch " + json.dumps(rec), flush=True)
    check(launches == expect, f"{what}: {launches} K3 launches, the "
                              f"lockstep schedule implies {expect}")
    check(bool((ratio <= 1.0 + COST_RISE).all()),
          f"{what}: {int((ratio > 1.0 + COST_RISE).sum())} scenarios ended "
          f"more than {COST_RISE} above their first cost")
    check(float(ratio.median()) < 1.0, f"{what}: the median cost did not "
                                       "fall")
    return rec


def kernel_line(name, replaces, launches, max_abs_err, rec,
                source="isdf_torch/csrc/sweep_warm.cu"):
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err, "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from isdf_torch.sweep import fused_zoom, grid_zoom
    except ImportError as e:
        print(f"chip_smoke: isdf_torch not importable ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    workdir = tempfile.TemporaryDirectory()
    try:
        t0 = time.perf_counter()
        libs = fused_zoom.compile_jobs(fused_zoom.build_jobs()
                                       + grid_zoom.build_jobs())
        print(f"build: K1, K2 and K4 for {len(libs) - 1} body-SDF kinds, "
              f"and K3 ({len(libs)} libraries, built in parallel) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        obj_path = write_l_robot(workdir.name)
        k1_recs, slice_case = phase_kernels(dev)
        k2_recs = phase_k2(dev)
        k4_recs = phase_k4(dev, slice_case)
        k3_recs = phase_k3(dev, obj_path)
        check(not KERNEL_FAILURES, "; ".join(KERNEL_FAILURES))
        _, k1_launches, pm, traj = phase_plan(dev)
        k4_launches = phase_refine(pm, traj)
        k2_launches, batch_case = phase_batch(dev)
        _, k3_launches, pm_mesh = phase_mesh_plan(dev, obj_path)
        phase_mesh_batch(dev, pm_mesh.shape)
        if "--profile" in sys.argv[1:]:
            phase_profile(pm, batch_case, pm_mesh)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        workdir.cleanup()

    # K1 at the plan's size and shape; K2 at the B = 128 solve's size, error
    # and times from the same case (the audit's and the B = 4096 case are in
    # the "K2 vs plain, timed" lines); K4 at the slice's size; K3 at the mesh
    # slice's size, its launches from the mesh plan.  K4 has no caller in
    # the package, as zoom_refine has none in the JAX package: its path is
    # its own entry point, driven by phase_refine.
    k1_main = next(r for r in k1_recs
                   if r["size"] == "slice" and r["shape"] == "RoundedCone")
    k2_main = next(r for r in k2_recs if r.get("ms") and r["B"] == 128)
    k4_main = next(r for r in k4_recs if r["shape"] == "RoundedCone")
    k3_main = next(r for r in k3_recs if r["case"] == "L/slice")
    kernels = [
        kernel_line("sweep_warm_fused", "isdf_tpu/sweep/pallas_zoom.py:414",
                    k1_launches, max(r["max_abs_d"] for r in k1_recs),
                    k1_main),
        kernel_line("sweep_warm_fused_batched",
                    "isdf_tpu/sweep/pallas_zoom.py:450", k2_launches,
                    k2_main["max_abs_d"], k2_main),
        kernel_line("zoom_refine", "isdf_tpu/sweep/pallas_zoom.py:213",
                    k4_launches, max(r["max_abs_d"] for r in k4_recs),
                    k4_main),
        kernel_line("grid_sweep_warm_fused",
                    "isdf_tpu/sweep/pallas_grid_zoom.py:311", k3_launches,
                    max(r["max_abs_d"] for r in k3_recs), k3_main,
                    source="isdf_torch/csrc/grid_sweep.cu"),
    ]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
