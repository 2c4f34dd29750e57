#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``isdf_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel of the main path from the sources
               (K1: isdf_torch/csrc/sweep_warm.cu) and print the seconds;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               (K1 against sweep_warm_fused_ref for RoundedCone (posed), Ball
               and CappedCone, at the slice's size, at the JAX bench's size
               and at the audit's two sizes) and time both with CUDA events;
  3. plan    — PlannerManager.plan on the demo-1 scene (RoundedCone body,
               procedural map4), with the launch counters set to 0 just
               before the plan and read just after.
With ``--profile`` it then plans once more under torch.profiler and prints
the device's busy share of that plan.  Then it prints the card's name and
power limit, one JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.
Without a CUDA card, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# K1's tolerance against its plain version (both float32 on the card).  The
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
# body SDFs; RoundedCone counts its cheapest branch, a lower bound
OPS_SDF = {"Ball": 8, "RoundedCone": 12, "CappedCone": 49}


def k1_ops_per_query(shape, coarse_n: int, rounds: int, k: int = 8) -> int:
    sdf = OPS_SDF[shape.name] + (OPS_POSED if shape.spec.posed else 0)
    scan = coarse_n * (OPS_REL + sdf)
    zooms = 2 * rounds * (k * (OPS_CAND + OPS_PVAJ + OPS_POSE + OPS_REL + sdf)
                          + OPS_PLATEAU)
    epilogue = OPS_PVAJ + OPS_POSE + OPS_REL + 4 * sdf   # dual: value + 3
    return scan + zooms + epilogue + 3


def k1_bound_ms(shape, P: int, N: int, coarse_n: int, rounds: int):
    """(bound ms, "operations" or "bytes"): the larger of the FP32 work over
    the FP32 non-tensor peak and the bytes (each input read once, each output
    written once) over the memory rate."""
    ops = P * k1_ops_per_query(shape, coarse_n, rounds)
    nbytes = 4 * (P * (3 + 1) + coarse_n * 12 + N * (2 + 18)) + 4 * P * 5
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


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
    """K1 against sweep_warm_fused_ref on the card → per-case records."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl, minco
    from isdf_torch.core.poly import PolyTraj
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom

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
        for shape_name, conf in shapes:
            shape = make_shape(shape_name, conf)
            params = fl.FlatParams.from_config(conf)
            args = kernel_inputs(torch, traj, params, pts, t_warm, coarse_n)
            kw = dict(coarse_n=coarse_n, rounds=rounds, warm_window=0.3)
            tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args, **kw)
            tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args,
                                                         **kw)
            torch.cuda.synchronize()
            for name, v in (("t*", tk), ("d*", dk), ("grad", gk)):
                check(bool(torch.isfinite(v).all()),
                      f"K1 {shape_name}/{size_name}: non-finite {name}")
            dd = (dk - dr).abs()
            d_ok = bool((dd <= D_ATOL + D_RTOL * dr.abs()).all())
            agree = (tk - tr).abs() < T_AGREE
            share = float(agree.float().mean())
            g_err = float((gk - gr).abs()[agree].max()) if agree.any() else 0.0
            ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused(
                shape, params, *args, **kw))
            plain_ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused_ref(
                shape, params, *args, **kw))
            bound, bound_by, ops, nbytes = k1_bound_ms(
                shape, len(pts_np), T.shape[0], coarse_n, rounds)
            rec = dict(size=size_name, shape=shape_name, P=len(pts_np),
                       N=int(T.shape[0]), coarse_n=coarse_n, rounds=rounds,
                       max_abs_d=float(dd.max()), t_share=share,
                       max_abs_grad=g_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=bound_by, ops=ops,
                       bytes=nbytes)
            records.append(rec)
            print("K1 vs plain " + json.dumps(rec), flush=True)
            check(d_ok, f"K1 {shape_name}/{size_name}: |Δd*| "
                        f"{rec['max_abs_d']:.3g} outside the band")
            check(share >= T_SHARE, f"K1 {shape_name}/{size_name}: only "
                                    f"{share:.4f} of points agree on t*")
            check(g_err <= G_ATOL, f"K1 {shape_name}/{size_name}: |Δgrad| "
                                   f"{g_err:.3g} > {G_ATOL}")
    return records


def phase_plan(dev):
    """PlannerManager.plan on the demo-1 scene; returns (metrics, launches)."""
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
    return m, launches, pm


def phase_profile(pm) -> None:
    """``--profile``: one more demo-1 plan (warm: A* already built) under
    torch.profiler, tracing the card only → the device's busy share of the
    plan's wall time, and K1's part of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pm.plan(np.asarray(START), np.asarray(GOAL), max_iters=MAX_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, k1_ns = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        if "sweep_warm" in e.name():
            k1_ns += e.end_ns() - e.start_ns()
    busy, end = 0, None                  # union of the device intervals
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if not spans:
        print("profile: the profiler recorded no device events; device "
              "busy share not measured", flush=True)
        return
    print("profile: " + json.dumps(dict(
        wall_s=wall, device_events=len(spans), device_busy_s=busy * 1e-9,
        busy_share=busy * 1e-9 / wall, k1_s=k1_ns * 1e-9)), flush=True)


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
        from isdf_torch.sweep import fused_zoom
    except ImportError as e:
        print(f"chip_smoke: isdf_torch not importable ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    try:
        t0 = time.perf_counter()
        lib = fused_zoom.build()
        print(f"build: K1 {lib.name} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        records = phase_kernels(dev)
        _, launches, pm = phase_plan(dev)
        if "--profile" in sys.argv[1:]:
            phase_profile(pm)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    main_rec = next(r for r in records
                    if r["size"] == "slice" and r["shape"] == "RoundedCone")
    k1 = {
        "name": "sweep_warm_fused",
        "route": "cuda",
        "source": "isdf_torch/csrc/sweep_warm.cu",
        "replaces": "isdf_tpu/sweep/pallas_zoom.py:414",
        "launches": launches,
        "max_abs_err": max(r["max_abs_d"] for r in records),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output")
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
