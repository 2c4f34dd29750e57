#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``isdf_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   — compile every kernel from the sources, all nvcc processes
               started together (K1, K2 and K4: isdf_torch/csrc/sweep_warm.cu,
               one library per body-SDF kind; K3: isdf_torch/csrc/
               grid_sweep.cu), print the seconds and the registers and
               spills ptxas reports for every kernel;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               and time both (the kernel's device time from torch.profiler
               and its call with CUDA events, the plain version's call with
               CUDA events):
               K1 against sweep_warm_fused_ref for RoundedCone (posed), Ball
               and CappedCone, at the slice's size, at the JAX bench's size
               and at the audit's two sizes, and for the other 17 zoo shapes
               at the slice's size; at the bench's latency solve (P = 512,
               N = 4, its second launch), bitwise;
               K2 against sweep_warm_fused_batched_ref and against K1
               launched per scenario, at B = 64 × P = 512, for CappedCone,
               CSG and Trefoil; then against its plain version and timed at
               the shapes the batched solves launch it at: warm at B = 128
               (every scenario) and B = 4096 (five scenarios), cold at
               the audit's coarse_n = 512 at B = 128, and the first launch
               of the bench's solves at B = 512 (every scenario) and
               B = 2048 (five scenarios), bitwise;
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
               batched_solve_audited at B = 128, each solved once and
               timed cold (the first call at its shapes in the process,
               printed as cold_wall_s: phase 19's bench takes the median of
               three after a warm call); the launch
               counters are set to 0 just before the B = 128 solve and read
               just after;
  4b. multi-device — parallel/mesh.py: in this process a world-1 NCCL
               group and a (1, 1) mesh, shard_batch and the B = 4096 solve,
               bitwise equal to phase 4's; then two spawned ranks sharing the
               one card (gloo; NCCL refuses two ranks on one card) at
               (dp, sp) = (2, 1) and (1, 2), B = 128: the chunked solve
               (8 iterations in two chunks of 4, the second resumed after
               the ranks' global_all; K2's counter set to 0 just before it
               in each rank), held as
               phase 4 holds its own (every scenario descends) and, with
               dp = 2, bitwise to its block solved without a mesh in float32
               and float64; a float64 batched_solve(max_iters=3) through the
               non-fused sweep (float64; K2 sweeps in float32) within the
               CPU tests' band of the unsharded one; one evaluation's t*
               bitwise to the unsharded one; the dp solve's placement
               equivariance; the L robot's sharded cost (K3's counter set to
               0 just before); then the ranks of
               parallel.dryrun.dryrun(world=2, sp=2) on the card.  K2 and K3
               are held against their plain versions at every shape the
               ranks launch them at.  It shows the path is right on the
               card, not how it scales;
  5. mesh    — a mesh robot: the demo-6 scene (an L-shaped thick prism
               written as an OBJ file, baked through shape_from_config;
               procedural map3) through PlannerManager.plan, K3's counter set
               to 0 just before the plan and read just after; then
               batched_solve_chunked with the L robot at the bench's width
               (B = 128), the counter set to 0 just before;
  6. planar  — the paper's 2-D experiments through plan_planar at their full
               configuration: demo 7 (Ball on planar_forest, the rotation
               decoupled) and demo 8 (a bar, Box 1.4 × 0.2 × 0.2, on
               planar_gaps, the yaw optimized), K1 under the planar pose map,
               its counter set to 0 just before each plan and read just
               after, then audit_planar;
  7. fly     — closed-loop replanning among two moving obstacles
               (fly_closed_loop on the JAX package's `closed-loop` cli scene),
               K1's counter set to 0 just before the flight and read just
               after, a LiveFlightView riding along (its /state.json read
               back once); then the planar instantiations no demo reaches, each
               through an entry point (K2: sweep_sdf_warm on a batch of
               planar trajectories; K4: zoom_refine; K3: audit_planar with
               the L robot), each counter set to 0 just before;
  8. planar kernels — after phase 2: K1 under the planar map at demo 8's
               size (warm and cold; beside it the tilt map on the same
               tables) and demo 7's, K2 at B = 8 (also against K1 per
               scenario), K4 and K3 (the L field, P = 4096) along demo 8's
               trajectory, each against its plain version and timed.
  9. lmbm    — demo 1's first back-end solve (the plan's mid-end result)
               again under backend.optimize(method="lmbm") capped at 20
               iterations and "lbfgs" capped at 200, each audited; K1's
               counter set to 0 just before each solve and read after its
               audit;
 10. golden  — the reference's whole-solve goldens (tests/golden/
               reference_solve_golden.json, gap and slalom): the initial
               cost and gradient at the reference's x0, the swept SDF on the
               reference's optimum, 80-iteration solves (L-BFGS float32,
               LMBM float64 held in the band; LMBM float32 printed, 20
               iterations);
 11. monitor — PlannerManager.plan(monitor=OptiMonitor()) on demo 1's
               scene, equal to phase 3's plan, its breakdowns and ASCII
               cost curve; a solve stopped through the Controller;
 12. non-fused — sweep_sdf_warm and sweep_sdf at coarse_n = 60 on demo 1's
               and the mesh plan's voxels against float64 on the CPU, and a
               hand-built shape with no device SDF on CUDA tensors: the
               non-fused path's counter counts exactly these calls, K1's
               and K3's none;
 13. run_demo — isdf_torch.demos.run_demo(7) and (8) on the default device,
               equal to phase 6's plans;
 14. swept   — viz.swept_volume_mesh at 0.25 m on phase 3's and phase 5's
               plans: K1 (K3) launches = 65,536-voxel chunks, the C++
               marching tetrahedra, the mesh enclosing the path, its
               vertices on the swept surface, sdf_time_curve at an audit
               voxel;
 15. monitor demo — run_demo(1) with an OptiMonitor, then the monitor's
               replay CSV and pose-kernel OBJ (the cost curve's PNG needs
               matplotlib: not drawn here);
 16. sim     — render_depth at 640 × 480 against the CPU in float64, a
               1,000-step hover under so3_control, sample_free_goals
               against the CPU;
 17. cli     — `python3 -m isdf_torch.cli` in its own process, as a user
               runs it, with a stand-in reference checkout as
               $ISDF_REFERENCE_ROOT (demo 1's map as a PCD, demo 6's L as an
               OBJ): demo 1 and demo 6 with --swept-mesh --view, demo 8,
               closed-loop --max-time 9, the four processes at once (so a
               run's wall, printed as wall_s_four_at_once, is not what a
               user running it alone waits); each must exit 0 and write the
               JAX cli's files;
 18. volume kernels — after phase 8: K1 and K3 at the swept-volume mesh's
               launch (P = 65,536, cold, coarse 128, rounds 24) against
               their plain versions, bitwise, and timed.
 19. bench   — after phase 17: `python3 -m isdf_torch.cli bench` (the
               benchmark harness, isdf_torch/bench.py) in its own process:
               the JAX bench's sections at its sizes (K1 at P = 32,768 and
               in a P = 512 solve, K2 in solves at B = 128, 512, 2048 and
               4096 and the audited B = 128, K3 on the 64³ torus); its last
               line, the record, checked (every key, rates above 0, every
               scenario finite, each section's kernel launched) and printed
               on a `bench: {...}` line; its launches per section go into
               the kernels line.
Phases 3–7, 9–17 and 19 run before phase 2: a process that has run the kernel
phase's torch.profiler traces planned and solved more slowly after them
(PERF.md §6).  With ``--profile`` it then plans once more under torch.profiler,
solves the B = 4096 batch once more under it and plans the mesh scene once
more under it, and prints the device's busy share of each.  Then it prints
the card's name and power limit, one JSON line with the kernels' numbers
(one entry per kernel and pose map, with the launches of each path that
runs it; and one entry per shape the bench launches a kernel at, with the
bench's launches there), and as the last line {"ok": true, "device": {...}}.
Each phase prints the seconds it took as it ends, and all of them again
on a "phases: seconds {...}" line before the card's name.  The whole run
takes 940-1010 s of the 1200 s it is allowed, the build included (PERF.md
§6): a phase that grows takes its time from another's depth, first the
plain version over all 512 scenarios of the B = 512 K2 case (about 64 s),
which would then hold five scenarios as at B = 2048.
Without a CUDA card, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# LMBM's re-solve of demo 1's back end (phase 9) stalls from its first
# iteration (ROADMAP §C1): capped at 20 iterations, not MAX_ITERS, to keep
# the smoke's time (uncapped it runs 153 iterations, ~57 s on the H100)
LMBM_DEMO1_ITERS = 20


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


def http_get(url: str) -> bytes:
    """GET from the live view on 127.0.0.1, past any proxy the environment
    names."""
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=10) as r:
        return r.read()


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


def kernel_ms(fn, kernel_word: str, warmup: int = 3, reps: int = 10,
              tries: int = 3):
    """Median device milliseconds of the kernel whose name holds
    kernel_word, over reps runs of fn(), read off torch.profiler's CUDA
    trace: the kernel's own time, without the host work of its wrapper (a
    CUDA-event pair around one call also times the wrapper's checks,
    allocations and launch, ~0.1 ms).  Now and then a trace comes back
    without the card's events, so a trace is taken up to `tries` times.
    → None if none of them recorded such a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [(e.end_ns() - e.start_ns()) * 1e-6
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and kernel_word in e.name()]
        if durs:
            return statistics.median(durs)
    return None


def timed(fn, kernel_word: str, what: str) -> dict:
    """A kernel call's times: ``ms``, the kernel's device time
    (:func:`kernel_ms`), and ``call_ms``, one call timed with CUDA events,
    wrapper included.  A kernel the profiler did not see fails the check."""
    call = cuda_ms(fn)
    dev = kernel_ms(fn, kernel_word)
    check_kernel(dev is not None,
                 f"{what}: torch.profiler recorded no {kernel_word}")
    return dict(ms=dev, call_ms=call)


def kernel_inputs(torch, traj, params, pts, t_warm, coarse_n):
    """K1's arguments for one trajectory.  ``params`` picks the pose map of
    the coarse pose table (sweep_sdf.traj_states): under PlanarPose the
    trajectory's third axis is the yaw and the table's z column z_ref."""
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
        cases = list(shapes)
        if size_name == "slice":
            # the other 17 zoo shapes, at the slice's size
            cases += [(name, Config()) for name in SHAPE_REGISTRY
                      if name not in dict(shapes)]
        for shape_name, conf in cases:
            shape = make_shape(shape_name, conf)
            params = fl.FlatParams.from_config(conf)
            args = kernel_inputs(torch, traj, params, pts, t_warm, coarse_n)
            kw = dict(coarse_n=coarse_n, rounds=rounds, warm_window=0.3)
            records.append(hold_k1(shape, params, args, kw, size_name))
    records.append(hold_latency_k1(dev))
    return records, slice_case


def hold_latency_k1(dev) -> dict:
    """K1 in the bench's latency solve (isdf_torch/bench.py section 7,
    P = 512, N = 4): the solve's second launch, warm from the first one's
    t*, held bitwise in t* and d* → its record."""
    from isdf_torch import bench
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom

    sizes = bench.BenchSizes()
    conf = bench.bench_config(sizes)
    _, cost_and_grad, x0, tw0 = bench.latency_solve(
        make_shape(bench.SHAPE, conf), conf, sizes, dev)
    t_star = cost_and_grad(x0, tw0)[2]
    calls = {}
    with _first_calls(fused_zoom, "sweep_warm_fused", calls):
        cost_and_grad(x0, t_star)
    (args, kw), = calls.values()
    rec = hold_k1(args[0], args[1], args[2:], kw, "latency512")
    check_kernel(rec["t_equal"] == 1.0 and rec["d_equal"] == 1.0,
                 f"K1 {rec['shape']}/latency512: t*, d* not bitwise equal "
                 f"to the plain version's ({rec})")
    return rec


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


def hold_k1(shape, params, args, kw, size_name):
    """One K1 case against sweep_warm_fused_ref on the card → its record."""
    import torch
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.utils.flops import is_planar, k1_bound_ms

    pts, durs = args[0], args[4]
    what = f"K1 {shape.name}/{size_name}"
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args, **kw)
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args, **kw)
    torch.cuda.synchronize()
    max_d, share, g_err, checks = in_bands(what, tk, dk, gk, tr, dr, gr)
    times = timed(lambda: fused_zoom.sweep_warm_fused(
        shape, params, *args, **kw), "sweep_warm_kernel", what)
    plain_ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused_ref(
        shape, params, *args, **kw), warmup=1, reps=3)
    planar = is_planar(params)
    bound, bound_by, ops, nbytes = k1_bound_ms(
        shape, pts.shape[0], durs.shape[0], kw["coarse_n"], kw["rounds"],
        planar=planar)
    rec = dict(size=size_name, shape=shape.name,
               pose="planar" if planar else "flat", P=pts.shape[0],
               N=durs.shape[0], coarse_n=kw["coarse_n"], rounds=kw["rounds"],
               cold=bool((args[1] == 0).all()), max_abs_d=max_d,
               t_share=share, max_abs_grad=g_err,
               t_equal=float((tk == tr).float().mean()),
               d_equal=float((dk == dr).float().mean()), **times,
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
    B = 64, then against its plain version and timed at the shapes the
    batched solves launch it at (the bench's B = 128, 512, 2048, 4096 and the
    audit) → records."""
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
    # read from global memory) at B = 128.  The plain version is a loop over
    # the scenarios (~0.1 s each): all of them at B = 128; at B = 4096 the
    # first, the last and three scenarios between
    for label, B, coarse_n, cold in (("B128", 128, None, False),
                                     ("B128/audit", 128, AUDIT_COARSE_N, True),
                                     ("B4096", 4096, None, False)):
        shape, params, args, kw = batched_kernel_inputs(
            torch, "CappedCone", B, dev, seed=2, coarse_n=coarse_n, cold=cold)
        records.append(hold_k2(shape, params, args, kw, label,
                               None if B == 128 else spread_rows(B)))
    records += [hold_first_k2(dev, 512), hold_first_k2(dev, 2048,
                                                       spread_rows(2048))]
    return records


def hold_first_k2(dev, B: int, rows=None) -> dict:
    """K2's first launch in the bench's solve at B (isdf_torch/bench.py
    section 4: make_random_batch's seed 0, the evaluation at x0 with
    t_warm = 0), held bitwise in t* and d* (``rows`` as in hold_k2) → its
    record."""
    from isdf_torch.config import Config
    from isdf_torch.parallel import batch as pb
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom

    conf = Config(**BATCH_CONF)
    sb = pb.make_random_batch(conf, B, N=BATCH_N, n_points=BATCH_P, seed=0,
                              device=dev)
    calls = {}
    with _first_calls(fused_zoom, "sweep_warm_fused_batched", calls):
        pb.batched_cost_and_grad(make_shape("CappedCone", conf), conf, sb,
                                 device=dev)
    (args, kw), = calls.values()
    return hold_k2(args[0], args[1], args[2:], kw, f"B{B}/first", rows,
                   exact=True)


def spread_rows(B: int) -> list:
    """The first, the last and three scenarios between."""
    return [0, B // 4, B // 2, 3 * B // 4, B - 1]


def hold_k2(shape, params, args, kw, label, rows=None, exact=False):
    """One K2 case at a batched solve's shape against its plain version on
    the card, and timed → its record.  ``rows`` None: every scenario,
    through one timed run of the batched plain version; else those
    scenarios, each through the single-scenario plain version.  With
    ``exact``, t* and d* must equal the plain version's bit for bit."""
    import torch
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.utils.flops import k1_bound_ms

    B, P = args[0].shape[:2]
    N = args[4].shape[-1]
    what = f"K2 {shape.name}/{label}"
    tk, dk, gk = fused_zoom.sweep_warm_fused_batched(
        shape, params, *args, **kw)
    times = timed(lambda: fused_zoom.sweep_warm_fused_batched(
        shape, params, *args, **kw), "sweep_warm_kernel", what)
    if rows is None:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(
            shape, params, *args, **kw)
        b.record()
        b.synchronize()
        plain_ms, rows = a.elapsed_time(b), slice(None)
    else:
        per = [fused_zoom.sweep_warm_fused_ref(
            shape, params, *(x[i] for x in args), **kw) for i in rows]
        tr, dr, gr = (torch.stack(o) for o in zip(*per))
        plain_ms = None
    torch.cuda.synchronize()
    tk, dk, gk = tk[rows], dk[rows], gk[rows]
    max_d, share, g_err, checks = in_bands(what, tk, dk, gk, tr, dr, gr)
    bound, bound_by, ops, nbytes = k1_bound_ms(
        shape, P, N, kw["coarse_n"], kw["rounds"], B=B)
    rec = dict(shape=shape.name, case=label, B=B, P=P, N=N,
               coarse_n=kw["coarse_n"], rounds=kw["rounds"],
               cold=bool((args[1] == 0).all()), compared_scenarios=len(tr),
               max_abs_d=max_d, t_share=share, max_abs_grad=g_err,
               t_equal=float((tk == tr).float().mean()),
               d_equal=float((dk == dr).float().mean()), **times,
               plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
               ops=ops, bytes=nbytes)
    print("K2 vs plain, timed " + json.dumps(rec), flush=True)
    for ok, msg in checks:
        check_kernel(ok, msg)
    if exact:
        check_kernel(rec["t_equal"] == 1.0 and rec["d_equal"] == 1.0,
                     f"{what}: t*, d* not bitwise equal to the plain "
                     f"version's ({rec})")
    return rec


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
    from isdf_torch.utils.flops import k4_bound_ms

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
        times = timed(lambda: fused_zoom.zoom_refine(
            shape, params, *args, rounds=12), "zoom_refine_kernel", what)
        plain_ms = cuda_ms(lambda: fused_zoom.zoom_refine_ref(
            shape, params, *args, rounds=12), warmup=1, reps=5)
        bound, bound_by, ops, nbytes = k4_bound_ms(
            shape, pts.shape[0], durs.shape[0], 12)
        rec = dict(shape=shape_name, P=pts.shape[0], N=durs.shape[0],
                   rounds=12, t_share=share, max_abs_d=float(dd.max()),
                   max_abs_t=float((tk - tr).abs().max()), **times,
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


def torus_grid(n: int, res: float, dev):
    """The JAX bench's torus field (bench.py:198-205: ring 0.6, tube 0.25)
    on an n³ grid of spacing res centred on the origin → GridField."""
    from isdf_torch.bench import torus_field
    from isdf_torch.sweep.grid_zoom import GridField

    field, origin = torus_field(n, res)
    return GridField.build(field, origin, res, dev)


def hold_k3(grid, params, args, kw, label, plain_reps: int = 3,
            batched: bool = False):
    """One K3 case against its plain version on the card → its record."""
    import torch
    from isdf_torch.sweep import grid_zoom
    from isdf_torch.utils.flops import is_planar, k3_bound_ms

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
    times = timed(lambda: kern(grid, params, *args, **kw),
                  "grid_sweep_kernel", what)
    plain_ms = cuda_ms(lambda: plain(grid, params, *args, **kw), warmup=1,
                       reps=plain_reps)
    B = pts.shape[0] if batched else 1
    P = pts.shape[-2]
    planar = is_planar(params)
    bound, bound_by, ops, nbytes = k3_bound_ms(
        grid, P, durs.shape[-1], kw["coarse_n"], kw["rounds"], B=B,
        planar=planar)
    rec = dict(case=label, pose="planar" if planar else "flat",
               field=list(grid.dims), B=B, P=P,
               N=durs.shape[-1], coarse_n=kw["coarse_n"],
               rounds=kw["rounds"], cold=bool((args[1] == 0).all()),
               max_abs_d=max_d, t_share=share, max_abs_grad=g_err,
               t_equal=float((tk == tr).float().mean()),
               d_equal=float((dk == dr).float().mean()),
               grad_equal=float((gk == gr).float().mean()),
               max_abs_t=float((tk - tr).abs().max()), **times,
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
            ("torus64/bench", torus_grid(64, 0.04, dev), bench, 64, 12),
            ("torus192/slice", torus_grid(192, 2.56 / 192, dev), warm,
             128, 24)):
        kw = dict(coarse_n=coarse_n, rounds=rounds, warm_window=0.3)
        records.append(hold_k3(g, params, args, kw, label))
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
    manager, the trajectory, the arguments of its first back-end solve)."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.opt import backend
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

    # the first back-end solve's arguments: the mid end's result, which
    # phase_lmbm solves again under both methods
    solves = []
    optimize = backend.optimize

    def recording(*a, **k):
        solves.append((a, k))
        return optimize(*a, **k)

    backend.optimize = recording
    fused_zoom.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        res = pm.plan(np.asarray(START), np.asarray(GOAL),
                      max_iters=MAX_ITERS)
        torch.cuda.synchronize()
    finally:
        backend.optimize = optimize
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
    return m, launches, pm, traj, solves[0]


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
    from isdf_torch.bench import busy_ns

    spans, k_ns = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        if kernel_word in e.name():
            k_ns += e.end_ns() - e.start_ns()
    busy = busy_ns(spans)
    if not spans:
        return {}
    return dict(wall_s=wall, device_events=len(spans),
                device_busy_s=busy * 1e-9, busy_share=busy * 1e-9 / wall,
                sweep_kernel_s=k_ns * 1e-9)


def phase_profile(pm, batch_case, pm_mesh, planar, dev) -> None:
    """``--profile``: one more demo-1 plan (warm: A* already built), one
    more B = 4096 batched solve, one more mesh plan, one more demo-8 planar
    plan and one more flight, each under torch.profiler tracing the card
    only → the device's busy share of each one's wall time, and the sweep
    kernel's part of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from isdf_torch.parallel import batch as pb
    from isdf_torch.plan import fly_closed_loop, plan_planar

    shape, conf, sb = batch_case
    d8 = planar["demo8"]
    runs = (
        ("plan", lambda: pm.plan(np.asarray(START), np.asarray(GOAL),
                                 max_iters=MAX_ITERS)),
        ("batch B=4096", lambda: pb.batched_solve_chunked(
            shape, conf, sb, max_iters=BATCH_ITERS, chunk=BATCH_CHUNK)),
        ("mesh plan", lambda: pm_mesh.plan(np.asarray(START6),
                                           np.asarray(GOAL6),
                                           max_iters=MAX_ITERS)),
        ("planar demo8", lambda: plan_planar(
            d8["params_conf"], d8["shape_obj"], d8["pts2"], (3.0, 3.0),
            (21.0, 21.0), yaw_opt=True, device=dev)),
        ("fly", lambda: fly_closed_loop(**fly_scene(dev), **FLY_RUN)),
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
    B = 128 solve, the B = 4096 case for ``--profile``, {B: (coeffs, T,
    costs, iters, K2 launches)} of the last timed solve at each B)."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.parallel import batch as pb
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom

    conf = Config(**BATCH_CONF)
    shape = make_shape("CappedCone", conf)
    trips = 2 * BATCH_CHUNK + 8          # loop trips per chunk, 2 evals each
    launches_main, big_case, small = None, None, None
    solved = {}

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
        # one solve, timed cold (the first at this B): the bench (phase 19)
        # times three after a warm call at every B
        fused_zoom.LAUNCHES_BATCHED = 0
        t0 = time.perf_counter()
        (coeffs, T, costs, iters), n_chunks = solve(sb)
        wall = time.perf_counter() - t0
        launches = fused_zoom.LAUNCHES_BATCHED
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
                   cold_wall_s=wall, cold_plans_per_s=B / wall,
                   accepted_steps_mean=float(iters.float().mean()),
                   no_accepted_step=stuck,
                   above_first_cost=int((ratio > 1.0).sum()),
                   cost_ratio_max=float(ratio.max()),
                   cost_first_median=float(f0.median()),
                   cost_final_median=float(costs.median()))
        print("batch " + json.dumps(rec), flush=True)
        solved[B] = (coeffs, T, costs, iters, launches)
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
    sb4 = sb.map(lambda t: t[:4])
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
        B=128, cold_wall_s=wall, cold_plans_per_s=128 / wall,
        k2_launches=fused_zoom.LAUNCHES_BATCHED,
        violations_per_round=hist, last_violations=hist[-1],
        min_sdf_min=float(audit["min_sdf"].min()),
        min_sdf_median=float(np.median(audit["min_sdf"])),
        scenarios_clear=int((audit["min_sdf"] > 1e-3).sum()))), flush=True)
    check(fused_zoom.LAUNCHES_BATCHED > 0, "the audited solve never "
                                           "launched K2")
    return launches_main, big_case, solved


# the multi-device phase (4b): two ranks share the one card; their chunked
# solves run 8 iterations in two chunks of 4, so the ranks decide together
# (global_all) whether to go on and resume the lockstep state in the second
MULTI_B = 128
MULTI_ITERS, MULTI_CHUNK = 8, 4
RANKS_TIMEOUT_S = 300
# an sp-sharded evaluation against the unsharded one: the point sum's
# float32 reduction order, the cost relative to itself and the gradient to
# its batch's largest entry
SP_COST_RTOL, SP_GRAD_RTOL = 1e-4, 1e-4
# a float64 three-iteration solve on a mesh against the unsharded one: the
# band of tests/test_torch_multidevice.py (tests/test_parallel.py:27-38)
F64_RTOL, C64_RTOL, C64_ATOL = 1e-8, 1e-6, 1e-8


def _solve_diff(a, b) -> dict:
    """Two solves' (coeffs, T, costs, iters): which are bitwise equal, how
    many scenarios end at the same cost and step count, the largest and the
    median relative cost difference."""
    import torch

    rel = ((a[2] - b[2]) / b[2]).abs()
    return dict(bitwise=[torch.equal(x, y) for x, y in zip(a, b)],
                costs_equal=int((a[2] == b[2]).sum()),
                iters_equal=int((a[3] == b[3]).sum()),
                max_rel_cost=float(rel.max()),
                median_rel_cost=float(rel.median()))


def _grad_rel(g, g_ref) -> float:
    return float((g - g_ref).abs().max() / g_ref.abs().max())


@contextlib.contextmanager
def _first_calls(module, name, calls: dict):
    """Within the block, ``module.name`` records in ``calls`` the arguments
    of its first call at each signature (the shapes of its tensors and its
    other numbers) → yields the function wrapped."""
    import torch

    real = getattr(module, name)

    def spy(*args, **kw):
        sig = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                    for a in (*args, *kw.values())
                    if isinstance(a, (torch.Tensor, int, float)))
        calls.setdefault(sig, (args, kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield real
    finally:
        setattr(module, name, real)


def _hold_calls(kernel, calls: dict, launch, plain) -> list:
    """Each recorded call replayed through the kernel's wrapper and its
    plain version on the same inputs → the kernel cases (t*, d* and the
    gradient compared; these launches count on no path)."""
    import torch

    cases = []
    for args, kw in calls.values():
        tk, dk, gk = launch(*args, **kw)
        tr, dr, gr = plain(*args, **kw)
        cases.append(dict(
            kernel=kernel, B=int(args[2].shape[0]), P=int(args[2].shape[1]),
            t_equal=torch.equal(tk, tr), d_equal=torch.equal(dk, dr),
            g_equal=torch.equal(gk, gr),
            max_abs_d=float((dk - dr).abs().max()),
            max_abs_grad=float((gk - gr).abs().max())))
    return cases


def _kernel_case_ok(c) -> bool:
    """K2 as the kernel phase holds it (t*, d* bitwise, the gradient within
    G_ATOL), K3 bitwise in all three."""
    return (c["t_equal"] and c["d_equal"]
            and (c["g_equal"] if c["kernel"] == "K3"
                 else c["max_abs_grad"] <= G_ATOL))


def multidevice_rank(rank, sp, obj_path, outdir):
    """One of two ranks on the one card (spawned by phase_multidevice, gloo):
    the bench's batch (B = 128, P = 512) on a (2/sp, sp) mesh through
    batched_solve_chunked (MULTI_ITERS iterations in chunks of MULTI_CHUNK,
    both run), K2's counter set to 0
    just before the solve and read just after; one cold evaluation's t*,
    cost and gradient against the unsharded evaluation's; the solve, in
    float32 and in float64, against the solve of this rank's scenarios
    without a mesh; a float64
    batched_solve(max_iters=3) on the mesh against the unsharded one
    through the non-fused sweep (float64) and through K2 (float32); with
    dp = 2 the solve of the batch rolled by one scenario; the L robot's
    batched_cost_and_grad on the mesh (K3, its counter set to 0 just
    before) against the unsharded one.  K2 and K3 are held against their
    plain versions on the first launch of each shape in the solve and the
    L robot's evaluation (this rank's B/dp × P/sp).  Writes rank{rank}.json
    and .npz."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl, timemap
    from isdf_torch.opt import backend
    from isdf_torch.parallel import batch as pb
    from isdf_torch.shapes import make_shape, shape_from_config
    from isdf_torch.sweep import fused_zoom, grid_zoom

    conf = Config(**BATCH_CONF)
    shape = make_shape("CappedCone", conf)
    mesh = pb.make_mesh(2, sp=sp)
    dev = mesh.device
    rec = dict(rank=rank, mesh=list(mesh.shape), dp_idx=mesh.dp_idx,
               sp_idx=mesh.sp_idx, device=str(dev),
               card=torch.cuda.get_device_name(dev))
    sb = pb.make_random_batch(conf, MULTI_B, N=BATCH_N, n_points=BATCH_P,
                              seed=0, device=dev)
    local = pb.shard_batch(sb, mesh)
    rows, cols = mesh.block(MULTI_B, "dp"), mesh.block(BATCH_P, "sp")
    kw = dict(max_iters=MULTI_ITERS, chunk=MULTI_CHUNK)

    k2_calls = {}
    with _first_calls(fused_zoom, "sweep_warm_fused_batched",
                      k2_calls) as k2:
        torch.cuda.synchronize()
        fused_zoom.LAUNCHES_BATCHED = 0
        t0 = time.perf_counter()
        out = pb.batched_solve_chunked(shape, conf, local, **kw)
        torch.cuda.synchronize()
        rec.update(solve_wall_s=time.perf_counter() - t0,
                   k2_launches=fused_zoom.LAUNCHES_BATCHED)
    cases = _hold_calls("K2", k2_calls, k2,
                        fused_zoom.sweep_warm_fused_batched_ref)

    # one cold evaluation: every point's t* is its own sweep's
    params = fl.FlatParams.from_config(conf)
    w = backend.BackendWeights.from_config(conf)

    def evaluate(b, group):
        cg = backend.make_cost_fn(
            shape, params, w, b.head, b.tail, BATCH_N, b.points, b.mask,
            integral_res=conf.integralIntervs,
            coarse_n=conf.sweep_coarse_samples,
            refine_rounds=conf.sweep_refine_rounds, sp_group=group)
        return cg(backend.pack(timemap.T_to_tau(b.T0), b.q0),
                  torch.zeros_like(b.points[..., 0]))

    f_s, g_s, t_s = evaluate(local, mesh.sp_group if sp > 1 else None)
    f_u, g_u, t_u = evaluate(sb, None)
    rec["eval"] = dict(
        t_star_equal=torch.equal(t_s, t_u[rows, cols]),
        max_rel_cost=float(((f_s - f_u[rows]) / f_u[rows]).abs().max()),
        grad_rel=_grad_rel(g_s, g_u[rows]))
    ratio = out[2][rows] / f_u[rows]
    rec["solve"] = dict(cost_ratio_max=float(ratio.max()),
                        cost_ratio_median=float(ratio.median()))
    arrays = dict(zip(("coeffs", "T", "costs", "iters"),
                      (t.cpu().numpy() for t in out)))

    # this rank's scenarios solved without a mesh in this process, float32
    # and float64: over dp the rank runs a batch of B/dp, which must give
    # that batch's solve bit for bit; over sp the point sum rounds otherwise
    sb64 = pb.make_random_batch(conf, MULTI_B, N=BATCH_N, n_points=BATCH_P,
                                seed=0, device=dev, dtype=torch.float64)
    out64 = pb.batched_solve_chunked(shape, conf, pb.shard_batch(sb64, mesh),
                                     **kw)
    for tag, full, mine in (("float32", sb, out), ("float64", sb64, out64)):
        alone = pb.batched_solve_chunked(
            shape, conf, full.map(lambda t: t[rows]), **kw)
        rec[f"block_{tag}"] = _solve_diff([t[rows] for t in mine], alone)
    # the CPU tests' witness: batched_solve(max_iters=3) in float64 on the
    # mesh against the whole batch's without a mesh, in their band.  K2
    # sweeps in float32 whatever the batch's type, so the witness sweeps
    # through the non-fused path, in float64 as on the CPU; K2's float64
    # solve is printed beside it
    for tag, s in (("solve3_float64", dataclasses.replace(shape, spec=None)),
                   ("solve3_float64_k2", shape)):
        three = [pb.batched_solve(s, conf, b, max_iters=3)
                 for b in (pb.shard_batch(sb64, mesh), sb64)]
        rec[tag] = dict(
            _solve_diff(*three),
            within_band=bool(
                torch.equal(three[0][3], three[1][3])
                and torch.allclose(three[0][2], three[1][2], rtol=F64_RTOL,
                                   atol=0)
                and all(torch.allclose(a, b, rtol=C64_RTOL, atol=C64_ATOL)
                        for a, b in zip(three[0][:2], three[1][:2]))))
    if mesh.dp > 1:
        rolled = sb.map(lambda t: torch.roll(t, 1, 0))
        out_r = pb.batched_solve_chunked(shape, conf,
                                         pb.shard_batch(rolled, mesh), **kw)
        rec["rolled_equal"] = [torch.equal(torch.roll(b, -1, 0), a)
                               for a, b in zip(out, out_r)]

    # the L robot (K3) on the mesh
    lshape = shape_from_config(Config(**DEMO6, inputdata=obj_path),
                               device=dev)
    k3_calls = {}
    with _first_calls(grid_zoom, "grid_sweep_warm_fused_batched",
                      k3_calls) as k3:
        torch.cuda.synchronize()
        grid_zoom.LAUNCHES_GRID = 0
        t0 = time.perf_counter()
        f_l, g_l = pb.batched_cost_and_grad(lshape, conf, local)
        torch.cuda.synchronize()
        rec.update(l_cost_wall_s=time.perf_counter() - t0,
                   k3_launches=grid_zoom.LAUNCHES_GRID)
    f_lu, g_lu = pb.batched_cost_and_grad(lshape, conf, sb)
    rec["l_cost"] = dict(
        max_rel_cost=float(((f_l - f_lu) / f_lu).abs().max()),
        grad_rel=_grad_rel(g_l, g_lu))
    rec["kernel_cases"] = cases + _hold_calls(
        "K3", k3_calls, k3, grid_zoom.grid_sweep_warm_fused_batched_ref)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    Path(outdir, f"rank{rank}.json").write_text(json.dumps(rec))


def dryrun_rank_held(rank, world, sp, outdir):
    """A rank of parallel.dryrun on the card (spawned by phase_multidevice,
    gloo) with its K2 and K3 calls recorded; after its sections the first
    launch of each shape is held against the plain version →
    outdir/kernels{rank}.json beside the dryrun's rank{rank}.json."""
    from isdf_torch.parallel.dryrun import dryrun_rank
    from isdf_torch.sweep import fused_zoom, grid_zoom

    k2_calls, k3_calls = {}, {}
    with _first_calls(fused_zoom, "sweep_warm_fused_batched",
                      k2_calls) as k2, \
            _first_calls(grid_zoom, "grid_sweep_warm_fused_batched",
                         k3_calls) as k3:
        dryrun_rank(rank, world, sp, None, outdir)
    cases = (_hold_calls("K2", k2_calls, k2,
                         fused_zoom.sweep_warm_fused_batched_ref)
             + _hold_calls("K3", k3_calls, k3,
                           grid_zoom.grid_sweep_warm_fused_batched_ref))
    Path(outdir, f"kernels{rank}.json").write_text(json.dumps(cases))


def phase_multidevice(solved, obj_path) -> dict:
    """Phase 4b, the multi-device path (parallel/mesh.py):
    (a) in this process a world-1 NCCL group and a (1, 1) mesh: shard_batch
        and batched_solve_chunked at B = 4096, bitwise equal to phase 4's
        solve without a mesh;
    (b) two spawned ranks on the one card, gloo (NCCL refuses two ranks on
        one card), at (dp, sp) = (2, 1) and (1, 2): multidevice_rank;
    (c) the ranks of isdf_torch.parallel.dryrun.dryrun(world=2, sp=2) on
        the card, K2 and K3 held at each shape they launch at:
        dryrun_rank_held.
    This measures that the path is right on the card, not how it scales.
    → {"K2"/"K3": {path: launches}, "cases": [kernel cases]}."""
    import torch
    import torch.distributed as dist
    from isdf_torch.config import Config
    from isdf_torch.parallel import batch as pb
    from isdf_torch.parallel.dryrun import run_ranks
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom

    conf = Config(**BATCH_CONF)
    shape = make_shape("CappedCone", conf)
    paths = {"K2": {}, "K3": {}}
    cases = []
    multi_trips = 2 * MULTI_CHUNK + 8
    multi_chunks = MULTI_ITERS // MULTI_CHUNK

    B = 4096
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv",
                                world_size=1, rank=0)
        try:
            mesh = pb.make_mesh(1, sp=1)
            sb = pb.shard_batch(pb.make_random_batch(
                conf, B, N=BATCH_N, n_points=BATCH_P, seed=0), mesh)
            torch.cuda.synchronize()
            fused_zoom.LAUNCHES_BATCHED = 0
            t0 = time.perf_counter()
            out = pb.batched_solve_chunked(shape, conf, sb,
                                           max_iters=BATCH_ITERS,
                                           chunk=BATCH_CHUNK)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_zoom.LAUNCHES_BATCHED
        finally:
            dist.destroy_process_group()
    ref = solved[B]
    same = [torch.equal(a, b) for a, b in zip(out, ref[:4])]
    print("multidevice 1x1 nccl " + json.dumps(dict(
        B=B, wall_s=wall, plans_per_s=B / wall, k2_launches=launches,
        phase4_k2_launches=ref[4], bitwise_equal_to_phase4=same)),
        flush=True)
    check(all(same), "a (1, 1) mesh's B = 4096 solve differs from phase 4's "
                     f"without a mesh (coeffs, T, costs, iters equal: {same})")
    check(launches == ref[4], f"(1, 1) mesh: {launches} K2 launches, "
                              f"{ref[4]} without a mesh")
    paths["K2"]["batched_solve_chunked mesh 1x1 nccl B = 4096"] = launches

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"multidevice: compute mode {mode!r}, {torch.cuda.device_count()} "
          "card(s); two gloo ranks share cuda:0", flush=True)
    check(mode.splitlines()[:1] == ["Default"],
          f"the card's compute mode {mode!r} refuses a second process")
    for sp in (1, 2):
        label = f"{2 // sp}x{sp}"
        with tempfile.TemporaryDirectory() as outdir:
            t0 = time.perf_counter()
            run_ranks(multidevice_rank, 2, (sp, obj_path, outdir),
                      backend_name="gloo", timeout=RANKS_TIMEOUT_S)
            spawn_s = time.perf_counter() - t0
            recs = [json.loads(Path(outdir, f"rank{r}.json").read_text())
                    for r in range(2)]
            outs = [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
                    for r in range(2)]
        summary = dict(
            mesh=label, B=MULTI_B, spawn_wall_s=spawn_s,
            ranks_equal=[bool(np.array_equal(outs[0][k], outs[1][k]))
                         for k in ("coeffs", "T", "costs", "iters")])
        for r in recs:
            print(f"multidevice {label} rank {r['rank']} " + json.dumps(r),
                  flush=True)
        print(f"multidevice {label} " + json.dumps(summary), flush=True)
        what = f"multidevice {label}"
        check(all(summary["ranks_equal"]),
              f"{what}: the two ranks return other results")
        for r in recs:
            rw = f"{what} rank {r['rank']}"
            # a rounding change of one evaluation can flip a line-search
            # test and send a scenario down another descent (PERF.md §6):
            # a solve whose sums round otherwise is held as phase 4 holds
            # its own, and the dp solve, whose sums do not change, bitwise
            # to its block's solve without a mesh
            check(r["solve"]["cost_ratio_max"] <= 1.0 + COST_RISE
                  and r["solve"]["cost_ratio_median"] < 0.9,
                  f"{rw}: the solve does not descend: {r['solve']}")
            if sp == 1:
                for k in ("block_float32", "block_float64"):
                    check(all(r[k]["bitwise"]),
                          f"{rw}: its block's solve without a mesh differs: "
                          f"{r[k]}")
            check(r["solve3_float64"]["within_band"],
                  f"{rw}: the float64 three-iteration solve leaves the "
                  f"unsharded one's band: {r['solve3_float64']}")
            check(r["k2_launches"] == 1 + 2 * multi_trips * multi_chunks,
                  f"{rw}: {r['k2_launches']} K2 launches, not 1 + 2 · "
                  f"{multi_trips} in each of {multi_chunks} chunks")
            check(r["k3_launches"] > 0, f"{rw}: K3 never launched")
            check(r["eval"]["t_star_equal"], f"{rw}: t* of one evaluation "
                                             "differs from the unsharded")
            check(r["eval"]["max_rel_cost"] <= SP_COST_RTOL
                  and r["eval"]["grad_rel"] <= SP_GRAD_RTOL,
                  f"{rw}: one evaluation off the unsharded: {r['eval']}")
            check(r["l_cost"]["max_rel_cost"] <= SP_COST_RTOL
                  and r["l_cost"]["grad_rel"] <= SP_GRAD_RTOL,
                  f"{rw}: the L robot's cost off the unsharded: "
                  f"{r['l_cost']}")
            check(all(r.get("rolled_equal", [True])),
                  f"{rw}: the dp solve depends on placement "
                  f"{r.get('rolled_equal')}")
            held = {c["kernel"] for c in r["kernel_cases"]}
            check(held == {"K2", "K3"}, f"{rw}: held only {held}")
            for c in r["kernel_cases"]:
                check_kernel(_kernel_case_ok(c),
                             f"{rw}: {c['kernel']} off its plain version "
                             f"({c})")
                cases.append(dict(c, mesh=label, rank=r["rank"]))
            paths["K2"][f"batched_solve_chunked mesh {label} rank "
                        f"{r['rank']}"] = r["k2_launches"]
            paths["K3"][f"batched_cost_and_grad L mesh {label} rank "
                        f"{r['rank']}"] = r["k3_launches"]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as outdir:
        run_ranks(dryrun_rank_held, 2, (2, 2, outdir), backend_name="gloo",
                  timeout=RANKS_TIMEOUT_S)
        recs = [(json.loads(Path(outdir, f"rank{r}.json").read_text()),
                 json.loads(Path(outdir, f"kernels{r}.json").read_text()))
                for r in range(2)]
    wall = time.perf_counter() - t0
    for r, held in recs:
        rw = f"dryrun rank {r['rank']}"
        print(f"multidevice {rw} " + json.dumps(r), flush=True)
        print(f"multidevice {rw} kernels " + json.dumps(held), flush=True)
        for k in ("K2", "K3"):
            n = sum(v[k] for v in r.values() if isinstance(v, dict)
                    and k in v)
            check(n > 0, f"{rw}: {k} never launched")
            check(any(c["kernel"] == k for c in held),
                  f"{rw}: no {k} launch held against its plain version")
            paths[k][rw] = n
        for c in held:
            check_kernel(_kernel_case_ok(c),
                         f"{rw}: {c['kernel']} off its plain version ({c})")
            cases.append(dict(c, mesh="dryrun", rank=r["rank"]))
    print(f"multidevice dryrun: world 2, sp 2, gloo, {wall:.2f} s",
          flush=True)
    return dict(paths, cases=cases)


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
    return m, launches, pm, traj


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


# the paper's 2-D experiments, demos 7 and 8 (isdf_tpu/demos.py:152-175), at
# their full configuration: nothing cut
DEMO7 = dict(occupancy_resolution=0.5, integralIntervs=16,
             sweep_coarse_samples=48, sweep_refine_rounds=8, vmax=5.0,
             omgmax=5.0, thetamax=1e3, safety_hor=0.3,
             max_obstacle_points=2048, inittime=2.0, weight_p=8000.0)
DEMO8 = dict(DEMO7, sweep_coarse_samples=64, vmax=4.0, omgmax=3.0,
             safety_hor=0.25, box_x=1.4, box_y=0.2, box_z=0.2)
PLANAR_DEMOS = (
    ("demo7", DEMO7, "Ball", "planar_forest", (2.0, 2.0), (28.0, 28.0),
     False),
    ("demo8", DEMO8, "Box", "planar_gaps", (3.0, 3.0), (21.0, 21.0), True),
)

# the closed-loop flight of the JAX package's cli (isdf_tpu/cli.py:99-140,
# `closed-loop` with its defaults): Ball, a slit wall, two moving obstacles
# drawn from default_rng(0), replan every 1.5 s for up to 30 s, 12 back-end
# iterations a replan
FLY = dict(mapBound=(0.0, 14.0, 0.0, 10.0, 0.0, 4.0),
           occupancy_resolution=0.5, kernel_size=3, safety_hor=0.3,
           integralIntervs=8, sweep_coarse_samples=16, sweep_refine_rounds=6,
           max_obstacle_points=512, vmax=4.0, omgmax=6.0, thetamax=1.2,
           mem_size=8)
FLY_START, FLY_GOAL = (1.0, 5.0, 2.0), (13.0, 5.0, 2.0)
FLY_RUN = dict(replan_dt=1.5, max_time=30.0, max_iters=12, goal_tol=1.0)


def phase_planar(dev):
    """plan_planar on demos 7 and 8, K1's counter set to 0 just before each
    plan and read just after; K1 must launch once per back-end evaluation
    and once for the plan's final sweep → {label: record with the shape,
    the trajectory and the map's points}."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.plan import audit_planar, plan_planar
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.world import maps_gen

    out = {}
    for label, d, shape_name, map_name, start, goal, yaw_opt in PLANAR_DEMOS:
        conf = Config(**d)
        shape = make_shape(shape_name, conf)
        pts2 = getattr(maps_gen, map_name)()
        fused_zoom.LAUNCHES = 0
        t0 = time.perf_counter()
        res = plan_planar(conf, shape, pts2, start, goal, yaw_opt=yaw_opt,
                          device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_zoom.LAUNCHES
        m = res.metrics
        check(res.success, f"{label}: plan_planar failed: {m}")
        audit = audit_planar(shape, res.traj, pts2, device=dev)
        phases = {k: m[k] for k in ("front_end_s", "mid_end_s",
                                    "back_end_s", "audit_s")}
        rec = dict(demo=label, shape=shape_name, map=map_name,
                   map_points=len(pts2), yaw_opt=yaw_opt,
                   n_pieces=m["n_pieces"],
                   obstacle_points=m["parallel_points_num"],
                   mid_end_iters=m["mid_end_iters"],
                   mid_end_evals=m["mid_end_evals"],
                   back_end_iters=m["back_end_iters"],
                   back_end_evals=m["back_end_evals"],
                   final_cost=m["final_cost"],
                   total_duration=m["total_duration"],
                   min_swept_sdf=m["min_swept_sdf"], audit_planar=audit,
                   k1_launches=launches, wall_s=wall, seconds=phases)
        print("planar " + json.dumps(rec), flush=True)
        traj = res.traj
        check(math.isfinite(m["final_cost"]),
              f"{label}: non-finite final cost")
        check(bool(torch.isfinite(traj.coeffs).all())
              and bool(torch.isfinite(traj.durations).all()),
              f"{label}: non-finite trajectory")
        ends = traj.junction_positions()[[0, -1], :2].cpu().numpy()
        check(np.linalg.norm(ends[0] - start) < 1e-3
              and np.linalg.norm(ends[1] - goal) < 1e-3,
              f"{label}: ends {ends.tolist()} are not {start} → {goal}")
        check(m["min_swept_sdf"] > 0.0,
              f"{label}: min swept SDF {m['min_swept_sdf']!r} ≤ 0")
        check(audit > 0.0, f"{label}: audit_planar {audit!r} ≤ 0")
        check(launches == m["back_end_evals"] + 1,
              f"{label}: {launches} K1 launches, expected "
              f"{m['back_end_evals']} + 1")
        out[label] = dict(rec, shape_obj=shape, traj=traj.detach(),
                          pts2=pts2, params_conf=conf)
    return out


def fly_scene(dev) -> dict:
    """The cli flight's arguments of fly_closed_loop: the manager, the
    static map, the obstacles and the controls' generator (both drawn from
    default_rng(0)), start and goal."""
    from isdf_torch.config import Config
    from isdf_torch.plan import PlannerManager
    from isdf_torch.world import MovingObstacle, maps_gen

    pm = PlannerManager(Config(**FLY), shape_name="Ball", device=dev)
    static = maps_gen.gene_wall(6.0, 0.0, 0.6, 3.5, 3.0, res=0.25)
    rng = np.random.default_rng(0)
    obstacles = [MovingObstacle(pos=rng.uniform((4, 2), (11, 8)),
                                radius=0.4, height=3.0) for _ in range(2)]
    return dict(pm=pm, static_points=static, obstacles=obstacles,
                start=np.asarray(FLY_START), goal=np.asarray(FLY_GOAL),
                rng=rng)


def phase_fly(dev):
    """fly_closed_loop on the cli's scene, K1's counter set to 0 just before
    the flight and read just after; K1 must launch once per back-end
    evaluation of every replan, and once per audit sweep that found voxels.
    A LiveFlightView on 127.0.0.1 (port 0) rides along: one GET of its
    /state.json after the flight must return the trail, the last plan (64
    samples) and the metrics; then the view is closed → the record."""
    import torch
    from isdf_torch.plan import fly_closed_loop
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.viz.live_view import LiveFlightView

    scene = fly_scene(dev)
    pm = scene["pm"]
    conf = pm.conf
    plans = []
    plan = pm.plan

    def recording(*a, **k):
        res = plan(*a, **k)
        plans.append(res.metrics)
        return res

    pm.plan = recording
    view = LiveFlightView(port=0, quiet=True)
    try:
        fused_zoom.LAUNCHES = 0
        t0 = time.perf_counter()
        log = fly_closed_loop(**scene, **FLY_RUN, live_view=view)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        state = json.loads(http_get(view.url + "state.json"))
    finally:
        view.close()
    launches = fused_zoom.LAUNCHES
    # one launch per back-end evaluation, and one per audit round that found
    # occupied voxels near the trajectory (an audit with none sweeps
    # nothing): at most one before every safety re-solve and one more
    evals = sum(m["back_end_evals"] for m in plans)
    audits_max = sum(min(m.get("safety_replans", 0) + 1,
                         conf.safety_replan_rounds) for m in plans)
    rep = log.replan_wall_s
    rec = dict(reached=log.reached, replans=len(rep), ticks=len(log.times),
               min_body_sdf=log.min_sdf,
               audited_ticks=len(log.min_body_sdf),
               replan_p50_s=statistics.median(rep) if rep else None,
               replan_max_s=max(rep) if rep else None,
               replan_s=rep, setup_s_mean=statistics.mean(log.setup_wall_s),
               setup_s=log.setup_wall_s,
               back_end_evals=[m["back_end_evals"] for m in plans],
               mid_end_evals=[m["mid_end_evals"] for m in plans],
               mid_end_s=[m["mid_end_s"] for m in plans],
               back_end_s=[m["back_end_s"] for m in plans],
               final_costs=[m["final_cost"] for m in plans],
               k1_launches=launches, audit_sweeps=launches - evals,
               wall_s=wall, pose_kernels=pm.pose_kernels is not None,
               live_view=dict(trail=len(state["trail"]),
                              plan=len(state["plan"]),
                              metrics=state["metrics"]))
    print("fly " + json.dumps(rec), flush=True)
    check(len(state["trail"]) == len(log.min_body_sdf)
          and len(state["plan"]) == 64
          and set(state["metrics"]) == {"t", "speed", "min_body_sdf",
                                        "replan_wall_s"},
          f"fly: the live view's state.json holds {len(state['trail'])} "
          f"trail points, {len(state['plan'])} plan samples, metrics "
          f"{sorted(state['metrics'])}")
    check(log.reached, f"fly: never reached the goal ({len(log.times)} "
                       f"ticks, last {log.positions[-1].tolist()})")
    check(log.min_sdf > 0.0, f"fly: body SDF {log.min_sdf!r} ≤ 0")
    check(all(np.isfinite(p).all() for p in log.positions),
          "fly: non-finite commanded position")
    check(launches > 0, "fly: the flight never launched K1")
    check(evals <= launches <= evals + audits_max,
          f"fly: {launches} K1 launches, the replans' {evals} evaluations "
          f"and up to {audits_max} audit sweeps imply {evals} to "
          f"{evals + audits_max}")
    return rec


def plane_points(torch, traj, pts2, P, dev, seed=11):
    """P query points at z = 0 as (P, 3) float32 on the card: the 2-D map's
    points nearest to a planar trajectory's path, and where the map has
    fewer than P, points drawn within ±2 m of the path (seeded)."""
    ts = torch.linspace(0.0, 1.0, 64, device=dev) * traj.total_duration
    path = traj.pos(ts)[:, :2]
    p2 = torch.as_tensor(pts2, dtype=torch.float32, device=dev)
    near = torch.cdist(p2, path).min(dim=1).values
    p2 = p2[torch.argsort(near)[:P]]
    if len(p2) < P:
        gen = torch.Generator().manual_seed(seed)
        k = P - len(p2)
        at = path[torch.randint(len(path), (k,), generator=gen).to(dev)]
        p2 = torch.cat([p2, at + (4 * torch.rand(k, 2, generator=gen)
                                  - 2).to(dev)])
    return torch.cat([p2, torch.zeros_like(p2[:, :1])], dim=1).contiguous()


def planar_batch(torch, traj, B, seed):
    """B planar trajectories through demo 8's waypoints, each piece's
    duration scaled by 0.7–1.3 → the batched PolyTraj."""
    from isdf_torch.core import minco
    from isdf_torch.core.poly import PolyTraj

    gen = torch.Generator(device="cpu").manual_seed(seed)
    dev = traj.durations.device
    T = traj.durations[None] * (0.7 + 0.6 * torch.rand(
        (B,) + tuple(traj.durations.shape), generator=gen)).to(dev)
    q = traj.junction_positions()[1:-1]
    ends = traj.junction_positions()[[0, -1]]
    head = torch.zeros(3, 3, device=dev)
    tail = torch.zeros(3, 3, device=dev)
    head[:, 0], tail[:, 0] = ends[0], ends[1]
    coeffs = torch.stack([minco.solve(q, T[b], head, tail)
                          for b in range(B)])
    return PolyTraj(T.contiguous(), coeffs.contiguous())


def phase_planar_paths(dev, planar, obj_path):
    """The planar instantiations that no demo reaches, each through an entry
    point a caller uses, its counter set to 0 just before and read just
    after: K2 through sweep_sdf_warm on a batch of B = 8 planar
    trajectories, K4 through zoom_refine on demo 8's points, K3 through
    audit_planar with the mesh robot (the L) along demo 8's trajectory
    → {kernel: launches}."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core.flatness import PlanarPose
    from isdf_torch.plan import audit_planar
    from isdf_torch.shapes import shape_from_config
    from isdf_torch.sweep import fused_zoom, grid_zoom
    from isdf_torch.sweep.sweep_sdf import sweep_sdf_warm

    d8 = planar["demo8"]
    params = PlanarPose(0.0)
    conf = d8["params_conf"]
    traj, shape = d8["traj"], d8["shape_obj"]
    pts = plane_points(torch, traj, d8["pts2"], 2048, dev)
    out = {}
    trajb = planar_batch(torch, traj, 8, seed=7)
    ptsb = pts[None].expand(8, -1, -1).contiguous()
    twb = torch.zeros(ptsb.shape[:2], device=dev)
    fused_zoom.LAUNCHES_BATCHED = 0
    sdf, _, _ = sweep_sdf_warm(shape, trajb, params, ptsb, twb,
                               coarse_n=conf.sweep_coarse_samples,
                               refine_rounds=conf.sweep_refine_rounds,
                               device=dev)
    torch.cuda.synchronize()
    out["K2"] = fused_zoom.LAUNCHES_BATCHED
    check(bool(torch.isfinite(sdf).all()), "planar K2 path: non-finite SDF")

    durs = traj.durations.contiguous()
    t0 = torch.rand(pts.shape[0], generator=torch.Generator().manual_seed(8)
                    ).to(dev) * traj.total_duration
    fused_zoom.LAUNCHES_ZOOM = 0
    t_ref = fused_zoom.zoom_refine(
        shape, params, pts, t0.contiguous(), torch.full_like(t0, 0.2),
        (torch.cumsum(durs, 0) - durs).contiguous(), durs,
        traj.coeffs.contiguous(), rounds=conf.sweep_refine_rounds)
    torch.cuda.synchronize()
    out["K4"] = fused_zoom.LAUNCHES_ZOOM
    check(bool(torch.isfinite(t_ref).all()), "planar K4 path: non-finite t*")

    lshape = shape_from_config(Config(**DEMO6, inputdata=obj_path),
                               device=dev)
    grid_zoom.LAUNCHES_GRID = 0
    audit = audit_planar(lshape, traj, d8["pts2"], device=dev)
    torch.cuda.synchronize()
    out["K3"] = grid_zoom.LAUNCHES_GRID
    print(f"planar paths: K2 {out['K2']} launch(es) through sweep_sdf_warm "
          f"(B = 8), K4 {out['K4']} through zoom_refine, K3 {out['K3']} "
          f"through audit_planar with the L robot (min swept SDF "
          f"{audit!r} along demo 8's path)", flush=True)
    check(math.isfinite(audit), "planar K3 path: non-finite audit")
    for k, n in out.items():
        check(n > 0, f"planar {k} path never launched {k}")
    return out


def phase_planar_kernels(dev, planar, obj_path):
    """The planar pose map in the kernel phase: K1 at demo 8's size (Box,
    P = 2048, demo 8's trajectory, coarse 64, rounds 8, warm and cold) and
    demo 7's (Ball, coarse 48), K2 at B = 8 (also bit for bit against K1
    per scenario), K4 on demo 8's case and K3 on the L field at P = 4096
    along demo 8's trajectory, each against its plain version and timed
    → {kernel: [records]}."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core.flatness import FlatParams, PlanarPose
    from isdf_torch.shapes import shape_from_config
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.sweep.fast_eval import sdf_at_time_c
    from isdf_torch.utils.flops import k1_bound_ms, k4_bound_ms

    params = PlanarPose(0.0)
    gen = torch.Generator().manual_seed(9)
    recs = {"K1": [], "K2": [], "K3": [], "K4": []}
    for label in ("demo8", "demo7"):
        d = planar[label]
        traj, shape, conf = d["traj"], d["shape_obj"], d["params_conf"]
        pts = plane_points(torch, traj, d["pts2"], 2048, dev)
        tw = (torch.rand(pts.shape[0], generator=gen).to(dev)
              * traj.total_duration)
        kw = dict(coarse_n=conf.sweep_coarse_samples,
                  rounds=conf.sweep_refine_rounds, warm_window=0.3)
        for cold in ((False, True) if label == "demo8" else (False,)):
            t_warm = torch.zeros_like(tw) if cold else tw
            args = kernel_inputs(torch, traj, params, pts, t_warm,
                                 kw["coarse_n"])
            recs["K1"].append(hold_k1(shape, params, args, kw,
                                      label + ("/cold" if cold else "")))
        if label == "demo8":
            # the tilt map at a like size: the same tables and points, the
            # third axis read as a height
            flat = FlatParams.from_config(conf)
            args = kernel_inputs(torch, traj, flat, pts, tw, kw["coarse_n"])
            recs["K1 tilt"] = [hold_k1(shape, flat, args, kw,
                                       "demo8 tables, tilt")]
    # K2 at B = 8, and K4, on demo 8's case
    d8 = planar["demo8"]
    traj, shape, conf = d8["traj"], d8["shape_obj"], d8["params_conf"]
    pts = plane_points(torch, traj, d8["pts2"], 2048, dev)
    B = 8
    trajb = planar_batch(torch, traj, B, seed=10)
    coarse_n, rounds = conf.sweep_coarse_samples, conf.sweep_refine_rounds
    kw = dict(coarse_n=coarse_n, rounds=rounds, warm_window=0.3)
    per = []
    for b in range(B):
        tb = type(traj)(trajb.durations[b], trajb.coeffs[b])
        tw = (torch.rand(pts.shape[0], generator=gen).to(dev)
              * tb.total_duration)
        per.append(kernel_inputs(torch, tb, params, pts, tw, coarse_n))
    args = tuple(torch.stack([a[i] for a in per]).contiguous()
                 for i in range(6))
    what = "K2 Box/demo8 B8 planar"
    tk, dk, gk = fused_zoom.sweep_warm_fused_batched(shape, params, *args,
                                                     **kw)
    tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(shape, params,
                                                         *args, **kw)
    one = [fused_zoom.sweep_warm_fused(shape, params, *a, **kw) for a in per]
    torch.cuda.synchronize()
    t1, d1, g1 = (torch.stack(o) for o in zip(*one))
    same = bool(torch.equal(tk, t1) and torch.equal(dk, d1)
                and torch.equal(gk, g1))
    max_d, share, g_err, checks = in_bands(what, tk, dk, gk, tr, dr, gr)
    times = timed(lambda: fused_zoom.sweep_warm_fused_batched(
        shape, params, *args, **kw), "sweep_warm_kernel", what)
    plain_ms = cuda_ms(lambda: fused_zoom.sweep_warm_fused_batched_ref(
        shape, params, *args, **kw), warmup=1, reps=3)
    bound, bound_by, ops, nbytes = k1_bound_ms(
        shape, pts.shape[0], traj.n_pieces, coarse_n, rounds, B=B,
        planar=True)
    rec = dict(shape=shape.name, pose="planar", case="demo8", B=B,
               P=pts.shape[0], N=traj.n_pieces, coarse_n=coarse_n,
               rounds=rounds, max_abs_d=max_d, t_share=share,
               max_abs_grad=g_err, t_equal=float((tk == tr).float().mean()),
               d_equal=float((dk == dr).float().mean()),
               equals_per_scenario_k1=same, **times, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by, ops=ops, bytes=nbytes)
    print("K2 vs plain, planar " + json.dumps(rec), flush=True)
    check_kernel(same, f"{what}: differs from K1 launched per scenario")
    for ok, msg in checks:
        check_kernel(ok, msg)
    recs["K2"].append(rec)

    durs = traj.durations.contiguous()
    tw = torch.rand(pts.shape[0], generator=gen).to(dev) * traj.total_duration
    w0 = 0.05 + 0.95 * torch.rand(pts.shape[0], generator=gen).to(dev)
    a4 = (pts, tw.contiguous(), w0.contiguous(),
          (torch.cumsum(durs, 0) - durs).contiguous(), durs,
          traj.coeffs.contiguous())
    what = "K4 Box/demo8 planar"
    tk = fused_zoom.zoom_refine(shape, params, *a4, rounds=rounds)
    tr = fused_zoom.zoom_refine_ref(shape, params, *a4, rounds=rounds)
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    with torch.no_grad():
        d_r = sdf_at_time_c(shape, traj, params, pw, tr)
        dd = (sdf_at_time_c(shape, traj, params, pw, tk) - d_r).abs()
    torch.cuda.synchronize()
    share = float(((tk - tr).abs() < T_AGREE).float().mean())
    times = timed(lambda: fused_zoom.zoom_refine(shape, params, *a4,
                                                 rounds=rounds),
                  "zoom_refine_kernel", what)
    plain_ms = cuda_ms(lambda: fused_zoom.zoom_refine_ref(
        shape, params, *a4, rounds=rounds), warmup=1, reps=5)
    bound, bound_by, ops, nbytes = k4_bound_ms(shape, pts.shape[0],
                                               traj.n_pieces, rounds,
                                               planar=True)
    rec = dict(shape=shape.name, pose="planar", case="demo8",
               P=pts.shape[0], N=traj.n_pieces, rounds=rounds,
               t_share=share, t_equal=float((tk == tr).float().mean()),
               max_abs_t=float((tk - tr).abs().max()),
               max_abs_d=float(dd.max()),
               **times, plain_ms=plain_ms, bound_ms=bound,
               bound_by=bound_by, ops=ops, bytes=nbytes)
    print("K4 vs plain, planar " + json.dumps(rec), flush=True)
    check(bool(torch.isfinite(tk).all()), f"{what}: non-finite t*")
    check_kernel(share >= T_SHARE,
                 f"{what}: only {share:.4f} of points agree on t*")
    check_kernel(bool((dd <= D_ATOL + D_RTOL * d_r.abs()).all()),
                 f"{what}: SDF at t* differs by {float(dd.max()):.3g}")
    recs["K4"].append(rec)

    # K3 on the L robot's field along demo 8's trajectory
    grid = shape_from_config(Config(**DEMO6, inputdata=obj_path),
                             device=dev).grid
    pts3 = plane_points(torch, traj, d8["pts2"], 4096, dev)
    tw = (torch.rand(pts3.shape[0], generator=gen).to(dev)
          * traj.total_duration)
    args = (pts3, tw.contiguous(), (torch.cumsum(durs, 0) - durs).contiguous(),
            durs, traj.coeffs.contiguous())
    recs["K3"].append(hold_k3(grid, params, args, kw, "L/demo8 planar"))
    return recs


# ---------------------------------------------------------------------------
# the back end's other ways in: LMBM, the reference's goldens, the
# monitored plan, the non-fused sweep and run_demo

def phase_lmbm(pm, solve1):
    """Demo 1's first back-end solve (the mid end's result, as the plan
    handed it to backend.optimize) again under method="lmbm", capped at
    LMBM_DEMO1_ITERS, and "lbfgs", capped at MAX_ITERS, each followed by the
    audit of its
    trajectory; K1's counter set to 0 just before each solve and read after
    its audit: launches = evaluations + audit sweeps, and the audit clean
    → {run: launches}.  (LMBM makes no serious step on this landscape: its
    trials start at t = 1 along −ĝ and 12 halvings never come near;
    ROADMAP §C1.  The JAX package's LMBM stalls the same way from the same
    start: tests/lmbm_demo1_witness.py.)"""
    import torch
    from isdf_torch.opt import backend
    from isdf_torch.sweep import fused_zoom

    args, kw = solve1
    out = {}
    for method, dtype, cap in (("lmbm", torch.float32, LMBM_DEMO1_ITERS),
                               ("lbfgs", torch.float32, MAX_ITERS)):
        label = f"{method} {str(dtype).removeprefix('torch.')}"
        fused_zoom.LAUNCHES = 0
        t0 = time.perf_counter()
        traj, res = backend.optimize(
            *args, **dict(kw, method=method, max_iters=cap,
                          monitor=None, dtype=dtype))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        solve_launches = fused_zoom.LAUNCHES
        min_sdf = pm.audit_collision(traj.detach())
        launches = fused_zoom.LAUNCHES
        audits = launches - solve_launches
        rec = dict(run=label, wall_s=wall, iters=res.n_iters,
                   evals=res.n_evals, final_cost=float(res.f),
                   converged=bool(res.converged), k1_launches=launches,
                   audit_sweeps=audits, audit_min_swept_sdf=min_sdf,
                   **(res.stats or {}))
        print("lmbm " + json.dumps(rec), flush=True)
        check(solve_launches == res.n_evals,
              f"{label}: {solve_launches} K1 launches for {res.n_evals} "
              "evaluations")
        check(audits == 1, f"{label}: the audit swept {audits} times")
        check(math.isfinite(float(res.f)), f"{label}: non-finite cost")
        check(min_sdf > 0.0, f"{label}: audit min swept SDF {min_sdf!r}")
        out[label] = launches
    return out


# the reference's whole-solve golden (tests/golden/
# reference_solve_golden.json, native/parity/ref_solve.cpp): fillConfig's
# values, as tests/test_parity_reference.py's _solve_conf has them
GOLDEN_CONF = dict(
    inputdata="shapes/RoundedCone.obj",
    poly_params=(0.0, 0.0, 0.0, 120.0, 0.0, 0.0),
    vehicleMass=0.61, gravAcc=9.8, horizDrag=0.10, vertDrag=0.10,
    parasDrag=0.01, speedEps=1e-4, smoothingEps=1e-2, integralIntervs=64,
    vmax=10.0, omgmax=10.0, thetamax=100.0, weight_v=1000.0,
    weight_omg=1000.0, weight_theta=1000.0, weight_p=4000.0, rho=20.0,
    safety_hor=0.866, mem_size=16, past=10, relCostTol=1e-16,
    sweep_coarse_samples=128, sweep_refine_rounds=24)
GOLDEN_ITERS = 80
# LMBM in float32, printed beside the held solves, not held: capped at 20
# iterations to keep the smoke's time
GOLDEN_PRINTED_ITERS = 20
GOLDEN_F0_RTOL = 1e-4      # the initial cost (tests/test_parity_reference.py)
GOLDEN_BAND = (0.6, 1.67)  # final cost over the reference's
GOLDEN_SDF_TOL = 5e-3      # the swept SDF on the reference's optimum


def phase_golden(dev):
    """The reference's two whole-solve scenarios (gap, slalom) on the card,
    held as tests/test_parity_reference.py holds the JAX package: the
    initial cost at the reference's x0 (float32), the swept SDF on the
    reference's own optimum, and 80-iteration solves, final cost within
    GOLDEN_BAND of the reference's and collision-free: L-BFGS in float32,
    LMBM in float64 (the golden config's dtype); LMBM in float32, capped at
    GOLDEN_PRINTED_ITERS, is printed beside them, not held → K1 launches of
    the solves."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core import flatness as fl
    from isdf_torch.core import minco, timemap
    from isdf_torch.core.poly import PolyTraj
    from isdf_torch.opt import backend
    from isdf_torch.shapes import make_shape
    from isdf_torch.sweep import fused_zoom, sweep_sdf

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden",
                           "reference_solve_golden.json")) as f:
        golden = json.load(f)
    conf = Config(**GOLDEN_CONF)
    shape = make_shape("RoundedCone", conf)
    params = fl.FlatParams.from_config(conf)
    f32 = dict(dtype=torch.float32, device=dev)
    launches = 0
    for name in ("gap", "slalom"):
        g = golden[name]
        N = int(g["n_pieces"])
        head = torch.as_tensor(np.reshape(g["head"], (3, 3)), **f32)
        tail = torch.as_tensor(np.reshape(g["tail"], (3, 3)), **f32)
        tau0 = torch.as_tensor(g["tau0"], **f32)
        q0 = torch.as_tensor(np.reshape(g["q0"], (-1, 3)), **f32)
        pts = torch.as_tensor(np.reshape(g["points"], (-1, 3)), **f32)
        mask = torch.ones(len(pts), dtype=torch.bool, device=dev)
        cg = backend.make_cost_fn(
            shape, params, backend.BackendWeights.from_config(conf), head,
            tail, N, pts, mask, integral_res=conf.integralIntervs,
            coarse_n=conf.sweep_coarse_samples,
            refine_rounds=conf.sweep_refine_rounds)
        f0, g0, _ = cg(backend.pack(tau0, q0), torch.zeros_like(pts[:, 0]))
        f0_rel = abs(float(f0) / g["f0"] - 1.0)
        g_ref, g_my = np.asarray(g["g0"]), g0.double().cpu().numpy()
        cos = float(g_my @ g_ref / (np.linalg.norm(g_my)
                                    * np.linalg.norm(g_ref)))

        T_ref = torch.as_tensor(g["final_T"], **f32)
        q_ref = torch.as_tensor(np.reshape(g["final_q"], (3, N - 1)).T,
                                **f32)
        ref_traj = PolyTraj(T_ref, minco.solve(q_ref, T_ref, head, tail))
        sdf_ref_opt = sweep_sdf(shape, ref_traj, params, pts, coarse_n=256,
                                refine_rounds=24)[0].double().cpu().numpy()
        ref = np.asarray(g["sdf_final"])
        near = ref < 10.0 - 1e-6            # the reference's sentinel
        sdf_err = float(np.max(np.abs(sdf_ref_opt[near] - ref[near])
                               / (1.0 + np.abs(ref[near]))))
        rec = dict(scenario=name, points=len(pts), f0=float(f0),
                   f0_ref=g["f0"], f0_rel_err=f0_rel, g0_cos=cos,
                   ref_optimum_sdf_err=sdf_err,
                   ref_final_cost=g["final_cost"], solves={})
        for method, dtype, held in (("lbfgs", torch.float32, True),
                                    ("lmbm", torch.float64, True),
                                    ("lmbm", torch.float32, False)):
            label = f"{method} {str(dtype).removeprefix('torch.')}"
            fused_zoom.LAUNCHES = 0
            t0 = time.perf_counter()
            traj, res = backend.optimize(
                shape, conf, head, tail, q0, timemap.tau_to_T(tau0), pts,
                mask, max_iters=GOLDEN_ITERS if held else
                GOLDEN_PRINTED_ITERS, method=method, params=params,
                device=dev, dtype=dtype)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches += fused_zoom.LAUNCHES
            check(fused_zoom.LAUNCHES == res.n_evals,
                  f"golden {name} {label}: {fused_zoom.LAUNCHES} K1 "
                  f"launches for {res.n_evals} evaluations")
            min_sdf = float(sweep_sdf(shape, traj.detach(), params,
                                      pts.to(dtype), coarse_n=256,
                                      refine_rounds=24)[0].min())
            ratio = float(res.f) / g["final_cost"]
            rec["solves"][label] = dict(
                wall_s=wall, iters=res.n_iters, evals=res.n_evals,
                final_cost=float(res.f), ratio=ratio, min_swept_sdf=min_sdf,
                **(res.stats or {}))
            if held:
                check(GOLDEN_BAND[0] < ratio < GOLDEN_BAND[1],
                      f"golden {name} {label}: final cost {float(res.f)!r} "
                      f"is {ratio:.3f}× the reference's")
                check(min_sdf > 0.0, f"golden {name} {label}: min swept "
                      f"SDF {min_sdf!r} ≤ 0")
        print("golden " + json.dumps(rec), flush=True)
        check(f0_rel <= GOLDEN_F0_RTOL,
              f"golden {name}: initial cost off by {f0_rel:.3g}")
        check(cos > 1.0 - 1e-4, f"golden {name}: gradient cosine {cos!r}")
        check(sdf_err <= GOLDEN_SDF_TOL,
              f"golden {name}: swept SDF on the reference's optimum off by "
              f"{sdf_err:.3g}")
        check(g["min_clearance"] > 0.0, f"golden {name}: reference collides")
    return launches


def phase_monitor(pm, plan_m, solve1):
    """PlannerManager.plan(monitor=OptiMonitor()) on demo 1's scene: the
    chunked solve equals the monolithic one, so success, iterations and
    cost equal phase_plan's plan; then one back-end solve stopped through
    the monitor's Controller must end after its first chunk → K1 launches
    of the monitored plan."""
    import torch
    from isdf_torch.opt import backend
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.utils.monitor import OptiMonitor
    from isdf_torch.utils.obs import Controller

    mon = OptiMonitor()
    fused_zoom.LAUNCHES = 0
    t0 = time.perf_counter()
    res = pm.plan(np.asarray(START), np.asarray(GOAL), max_iters=MAX_ITERS,
                  monitor=mon)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_zoom.LAUNCHES
    m = res.metrics
    keys = ("back_end_iters", "back_end_evals", "final_cost")
    diff = {k: m[k] - plan_m[k] for k in keys}
    print(f"monitor: plan(monitor=) success={res.success} wall {wall:.2f} s, "
          f"{len(mon.total)} breakdowns over {mon.solves} solve(s); against "
          f"the plain plan: " + json.dumps(diff), flush=True)
    print(mon.cost_curve_ascii(), flush=True)
    check(res.success, "monitor: the monitored plan failed")
    check(diff["back_end_iters"] == 0 and diff["back_end_evals"] == 0
          and abs(diff["final_cost"]) <= 1e-5 * abs(plan_m["final_cost"]),
          f"monitor: the monitored plan differs from the plain one: {diff}")
    check(mon.solves == 1 + m.get("safety_replans", 0)
          and len(mon.total) >= mon.solves,
          f"monitor: {len(mon.total)} breakdowns over {mon.solves} solves")
    for i, tot in enumerate(mon.total):
        parts = mon.energy[i] + mon.time_cost[i] + mon.dyn[i] + mon.safety[i]
        check(abs(tot - parts) <= 1e-4 * max(abs(tot), 1.0),
              f"monitor: breakdown {i} sums to {parts!r}, total {tot!r}")

    ctl = Controller()
    ctl.stop()
    args, kw = solve1
    _, stopped = backend.optimize(
        *args, **dict(kw, monitor=OptiMonitor(controller=ctl),
                      monitor_chunk=4))
    print(f"monitor: a solve stopped through the Controller ran "
          f"{stopped.n_iters} iterations", flush=True)
    check(stopped.n_iters == 4, f"monitor: the stopped solve ran "
          f"{stopped.n_iters} iterations, not one chunk of 4")
    return launches


NON_FUSED_COARSE = 60
# the swept SDF, card float32 against CPU float64, metres; t* is printed
# (the share of points whose t* agree within 1e-3 s), not held: inside the
# body the SDF is flat over an interval of t, and rounding moves the
# plateau's centre
NON_FUSED_SDF_ATOL = 1e-3


def phase_non_fused(pm, traj, pm_mesh, traj_mesh, obj_path):
    """sweep_sdf_warm and sweep_sdf at coarse_n = 60 (not a multiple of 8,
    so not the kernels) on demo 1's shape and its audit voxels, and on the
    L robot's field and the mesh plan's voxels, each held against the same
    call in float64 on the CPU; then a hand-built analytic shape with no
    device SDF, warm and cold at coarse_n = 64, its cold sweep held against
    K1's on the zoo Ball.  The references run first; then the counters are
    set to 0, the card's calls made, and the non-fused path's counter must
    count exactly them, K1's and K3's none."""
    import torch
    from isdf_torch.config import Config
    from isdf_torch.core.poly import PolyTraj
    from isdf_torch.shapes import Shape, make_shape, shape_from_config
    from isdf_torch.sweep import fused_zoom, grid_zoom

    sweeps = importlib.import_module("isdf_torch.sweep.sweep_sdf")
    dev = pm.device
    F64 = torch.float64
    cases = []
    for label, man, tr in (("demo 1 RoundedCone", pm, traj),
                           ("mesh L", pm_mesh, traj_mesh)):
        live, _, t_audit = man._audit_sdf(tr)
        check(live is not None, f"non-fused {label}: no voxels")
        cpu_shape = (make_shape("RoundedCone", man.conf) if man is pm else
                     shape_from_config(Config(**DEMO6, inputdata=obj_path),
                                       device="cpu", dtype=F64))
        tr = tr.detach()
        kw = dict(coarse_n=NON_FUSED_COARSE,
                  refine_rounds=man.conf.sweep_refine_rounds)
        cpu_tr = PolyTraj(tr.durations.double().cpu(),
                          tr.coeffs.double().cpu())
        pts = torch.as_tensor(live, dtype=torch.float32, device=dev)
        tw = torch.as_tensor(t_audit, dtype=torch.float32, device=dev)
        with torch.no_grad():
            refs = dict(
                warm=sweeps.sweep_sdf_warm(
                    cpu_shape, cpu_tr, man.params, pts.double().cpu(),
                    tw.double().cpu(), device="cpu", **kw),
                cold=sweeps.sweep_sdf(cpu_shape, cpu_tr, man.params,
                                      pts.double().cpu(), device="cpu", **kw))
        cases.append((label, man, tr, pts, tw, kw, refs))
    ball = make_shape("Ball", pm.conf)
    bare = Shape("HandBuilt", ball.sdf, ball.bounds, sdf3=ball.sdf3)
    pts1 = cases[0][3]
    with torch.no_grad():
        kern = sweeps.sweep_sdf(ball, traj.detach(), pm.params, pts1,
                                coarse_n=64, refine_rounds=8, device=dev)

    sweeps.XLA_CALLS = 0
    fused_zoom.LAUNCHES = grid_zoom.LAUNCHES_GRID = 0
    for label, man, tr, pts, tw, kw, refs in cases:
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = dict(
                warm=sweeps.sweep_sdf_warm(man.shape, tr, man.params, pts,
                                           tw, device=dev, **kw),
                cold=sweeps.sweep_sdf(man.shape, tr, man.params, pts,
                                      device=dev, **kw))
        torch.cuda.synchronize()
        rec = dict(case=label, points=len(pts),
                   wall_s=time.perf_counter() - t0)
        for k in outs:
            d = (outs[k][0].double().cpu() - refs[k][0]).abs()
            share = float(((outs[k][1].double().cpu() - refs[k][1]).abs()
                           < 1e-3).double().mean())
            rec[k] = dict(max_abs_sdf=float(d.max()), t_share=share)
            check(float(d.max()) <= NON_FUSED_SDF_ATOL,
                  f"non-fused {label} {k}: SDF off by {float(d.max()):.3g}")
        print("non-fused " + json.dumps(rec), flush=True)
    with torch.no_grad():
        warm = sweeps.sweep_sdf_warm(bare, traj.detach(), pm.params, pts1,
                                     torch.zeros_like(pts1[:, 0]),
                                     coarse_n=64, refine_rounds=8, device=dev)
        cold = sweeps.sweep_sdf(bare, traj.detach(), pm.params, pts1,
                                coarse_n=64, refine_rounds=8, device=dev)
    torch.cuda.synchronize()
    d = float((cold[0] - kern[0]).abs().max())
    print(f"non-fused: hand-built Ball (no device SDF) on {len(pts1)} voxels: "
          f"warm min {float(warm[0].min())!r}, cold min "
          f"{float(cold[0].min())!r}, max |cold - K1 on the zoo Ball| {d!r}; "
          f"non-fused calls {sweeps.XLA_CALLS}, K1 launches "
          f"{fused_zoom.LAUNCHES}, K3 launches {grid_zoom.LAUNCHES_GRID}",
          flush=True)
    check(bool(torch.isfinite(warm[0]).all() & torch.isfinite(cold[0]).all()),
          "non-fused: the hand-built shape's sweep is not finite")
    check(d <= NON_FUSED_SDF_ATOL,
          "non-fused: the hand-built Ball disagrees with K1's Ball")
    check(sweeps.XLA_CALLS == 2 * len(cases) + 2,
          f"non-fused: {sweeps.XLA_CALLS} calls counted, "
          f"{2 * len(cases) + 2} made")
    check(fused_zoom.LAUNCHES == 0 and grid_zoom.LAUNCHES_GRID == 0,
          f"non-fused: K1/K3 launched {fused_zoom.LAUNCHES}/"
          f"{grid_zoom.LAUNCHES_GRID} times for non-fused sweeps")


def phase_run_demo(planar):
    """isdf_torch.demos.run_demo(7) and (8) with the default device: the
    cost and success must match phase_planar's plan_planar runs → {demo:
    K1 launches}."""
    import torch
    from isdf_torch import demos
    from isdf_torch.sweep import fused_zoom

    out = {}
    for demo_id, label in ((7, "demo7"), (8, "demo8")):
        fused_zoom.LAUNCHES = 0
        t0 = time.perf_counter()
        _, res = demos.run_demo(demo_id)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = res.metrics
        ref = planar[label]
        rec = dict(demo=demo_id, wall_s=wall, success=res.success,
                   final_cost=m["final_cost"],
                   plan_planar_cost=ref["final_cost"],
                   back_end_evals=m["back_end_evals"],
                   k1_launches=fused_zoom.LAUNCHES)
        print("run_demo " + json.dumps(rec), flush=True)
        check(res.success, f"run_demo({demo_id}) failed")
        check(abs(m["final_cost"] - ref["final_cost"])
              <= 1e-5 * abs(ref["final_cost"]),
              f"run_demo({demo_id}): cost {m['final_cost']!r}, plan_planar "
              f"{ref['final_cost']!r}")
        check(fused_zoom.LAUNCHES == m["back_end_evals"] + 1,
              f"run_demo({demo_id}): {fused_zoom.LAUNCHES} K1 launches")
        out[demo_id] = fused_zoom.LAUNCHES
    return out


# the swept-volume mesh (viz/swept_mesh.py): the resolution the JAX cli
# takes by default (--mesh-res 0.25) and sdf_volume's chunk
SWEPT_RES = 0.25
SWEPT_CHUNK = 65536


def write_reference_root(dirpath: str, obj_path: str) -> str:
    """A stand-in reference checkout for the demos' assets → its root: demo
    1's map as an ASCII PCD of maps_gen.map4(res=0.8, seed=0) (phase 3's
    stand-in for CappedCone.pcd) and demo 6's Lthick.obj (the synthetic L
    of write_l_robot)."""
    import shutil

    from isdf_torch.world import maps_gen

    pm_dir = os.path.join(dirpath, "reference", "src", "plan_manager")
    os.makedirs(os.path.join(pm_dir, "map_pcds"))
    os.makedirs(os.path.join(pm_dir, "shapes"))
    pts = maps_gen.map4(res=0.8, seed=0)
    with open(os.path.join(pm_dir, "map_pcds", "CappedCone.pcd"), "w") as f:
        f.write("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n"
                "TYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        np.savetxt(f, pts, fmt="%.6f")
    shutil.copy(obj_path, os.path.join(pm_dir, "shapes", "Lthick.obj"))
    return os.path.join(dirpath, "reference")


def inside_point(torch, shape, dev):
    """A body-frame point inside the body: the frame's origin where the body
    holds it (the zoo's shapes), else the baked field's deepest voxel (the
    L robot's origin lies 0.2 m outside its arms)."""
    zero = torch.zeros(1, 3, dtype=torch.float32, device=dev)
    if float(shape.sdf(zero)[0]) < 0.0 or shape.grid is None:
        return zero[0]
    g = shape.grid
    i = int(torch.argmin(g.field))
    idx = torch.tensor(np.unravel_index(i, tuple(g.dims)), device=dev)
    origin = torch.as_tensor(g.origin, dtype=torch.float32, device=dev)
    return origin + idx.to(torch.float32) * g.res


def phase_swept(pm, traj, pm_mesh, traj_mesh):
    """viz.swept_volume_mesh at resolution 0.25 on phase 3's demo-1 plan (K1)
    and phase 5's mesh plan (K3), the counters set to 0 just before each and
    read just after: one cold launch per 65,536-voxel chunk, no non-fused
    sweep, and the C++ marching tetrahedra (never the Python twin).  Then
    the mesh's quality: the swept SDF at the body's inside point carried
    along 400 trajectory samples is < 0 (the mesh encloses the path), the
    re-swept SDF at 1,000 mesh vertices is within the resolution of 0, and
    sdf_time_curve at the audit's deepest voxel never goes below that
    voxel's swept SDF by more than 1e-4 → {label: record}."""
    import torch
    from isdf_torch import native, viz
    from isdf_torch.sweep import fused_zoom, grid_zoom, traj_states
    from isdf_torch.viz import export, swept_mesh

    sweeps = importlib.import_module("isdf_torch.sweep.sweep_sdf")
    split = {}
    sdf_volume, tetrahedra = swept_mesh.sdf_volume, native.marching_tetrahedra

    def timed_volume(*a, **k):
        t0 = time.perf_counter()
        field = sdf_volume(*a, **k)
        split.update(voxels=int(field.size),
                     sdf_volume_s=time.perf_counter() - t0)
        return field

    def timed_tetrahedra(*a, **k):
        t0 = time.perf_counter()
        tris = tetrahedra(*a, **k)
        split["tetrahedra_s"] = time.perf_counter() - t0
        return tris

    out = {}
    swept_mesh.sdf_volume = timed_volume
    native.marching_tetrahedra = timed_tetrahedra
    try:
        for label, man, tr in (("demo 1 RoundedCone", pm, traj),
                               ("demo 6 L", pm_mesh, traj_mesh)):
            split.clear()
            tr = tr.detach()
            mesh_robot = man.shape.grid is not None
            swept_mesh.PY_TWIN_CALLS = sweeps.XLA_CALLS = 0
            fused_zoom.LAUNCHES = grid_zoom.LAUNCHES_GRID = 0
            t0 = time.perf_counter()
            tris = viz.swept_volume_mesh(man.shape, tr, man.params,
                                         resolution=SWEPT_RES,
                                         device=man.device)
            wall = time.perf_counter() - t0
            counts = dict(k1=fused_zoom.LAUNCHES,
                          k3=grid_zoom.LAUNCHES_GRID,
                          non_fused=sweeps.XLA_CALLS,
                          python_twin=swept_mesh.PY_TWIN_CALLS)
            chunks = -(-split["voxels"] // SWEPT_CHUNK)
            launches = counts["k3" if mesh_robot else "k1"]

            dur = tr.durations
            with torch.no_grad():
                ts = torch.linspace(0.0, float(tr.total_duration), 400,
                                    dtype=dur.dtype, device=dur.device)
                xs, Rs = traj_states(tr, man.params, ts)
                body = inside_point(torch, man.shape, dur.device)
                path = (xs + Rs @ body).contiguous()
                on_path = sweeps.sweep_sdf(man.shape, tr, man.params,
                                           path, device=man.device)[0]
                V = torch.as_tensor(tris.reshape(-1, 3), dtype=dur.dtype,
                                    device=dur.device)
                pick = torch.linspace(0, len(V) - 1, 1000).long()
                on_mesh = sweeps.sweep_sdf(man.shape, tr, man.params,
                                           V[pick].contiguous(),
                                           device=man.device)[0]
                body_sdf = float(man.shape.sdf(body[None])[0])
            live, sdf, _ = man._audit_sdf(tr)
            i = int(np.argmin(sdf))
            _, curve = export.sdf_time_curve(man.shape, tr, man.params,
                                             live[i])
            rec = dict(case=label, resolution=SWEPT_RES,
                       voxels=split["voxels"], chunks=chunks,
                       launches=launches, **counts,
                       sdf_volume_s=split["sdf_volume_s"],
                       tetrahedra_s=split["tetrahedra_s"], wall_s=wall,
                       triangles=int(len(tris)), inside_point_sdf=body_sdf,
                       cpp_core=native.get_lib() is not None
                       and counts["python_twin"] == 0,
                       path_max_sdf=float(on_path.max()),
                       vertex_max_abs_sdf=float(on_mesh.abs().max()),
                       curve_min=float(curve.min()),
                       audit_voxel_sdf=float(sdf[i]))
            print("swept " + json.dumps(rec), flush=True)
            check(launches == chunks,
                  f"swept {label}: {launches} launches for {chunks} chunks")
            check(counts["k1" if mesh_robot else "k3"] == 0
                  and counts["non_fused"] == 0,
                  f"swept {label}: other sweeps ran: {counts}")
            check(rec["cpp_core"],
                  f"swept {label}: the marching tetrahedra ran in Python")
            check(len(tris) > 0 and np.isfinite(tris).all(),
                  f"swept {label}: {len(tris)} triangles")
            check(body_sdf < 0.0 and rec["path_max_sdf"] < 0.0,
                  f"swept {label}: the path leaves the swept volume "
                  f"(max SDF {rec['path_max_sdf']!r})")
            check(rec["vertex_max_abs_sdf"] <= SWEPT_RES,
                  f"swept {label}: a mesh vertex lies "
                  f"{rec['vertex_max_abs_sdf']!r} off the swept surface")
            check(rec["curve_min"] >= rec["audit_voxel_sdf"] - 1e-4,
                  f"swept {label}: SDF(t) dips to {rec['curve_min']!r} "
                  f"below the swept SDF {rec['audit_voxel_sdf']!r}")
            out[label] = rec
    finally:
        swept_mesh.sdf_volume = sdf_volume
        native.marching_tetrahedra = tetrahedra
    return out


def phase_monitor_demo(workdir: str, dev) -> int:
    """demos.run_demo(1) with an OptiMonitor, as `cli demo 1 --monitor` runs
    it, K1's counter set to 0 just before and read just after; then the
    monitor's artifacts export_replay_csv and export_kernel_obj.  The cost
    curve's PNG needs matplotlib, which the card's machine lacks: it is not
    drawn here (tests/test_torch_cli.py draws it on the CPU) → K1
    launches."""
    import torch
    from isdf_torch import demos
    from isdf_torch.sweep import fused_zoom
    from isdf_torch.utils.monitor import (OptiMonitor, export_kernel_obj,
                                          export_replay_csv)

    mon = OptiMonitor()
    fused_zoom.LAUNCHES = 0
    t0 = time.perf_counter()
    pm1, res = demos.run_demo(1, max_iters=MAX_ITERS, monitor=mon,
                              device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_zoom.LAUNCHES
    check(res.success, "monitor demo: run_demo(1) failed")
    replay = export_replay_csv(os.path.join(workdir, "replay.csv"), res.traj,
                               pm1.params)
    kernel = export_kernel_obj(os.path.join(workdir, "pose_kernel.obj"),
                               pm1.pose_kernels,
                               resolution=pm1.conf.occupancy_resolution)
    rows = np.loadtxt(replay, delimiter=",", skiprows=1)
    with open(kernel) as f:
        cubes = sum(line.startswith("v ") for line in f) // 8
    rec = dict(wall_s=wall, final_cost=res.metrics["final_cost"],
               breakdowns=len(mon.total), solves=mon.solves,
               replay_rows=int(len(rows)), kernel_voxels=cubes,
               k1_launches=launches)
    print("monitor demo " + json.dumps(rec), flush=True)
    print("monitor demo: cost_curve.png skipped (matplotlib is not "
          "installed on the card's machine)", flush=True)
    check(len(mon.total) >= 1 and launches > 0,
          f"monitor demo: {len(mon.total)} breakdowns, {launches} launches")
    check(rows.shape[1] == 8 and np.isfinite(rows).all() and cubes > 0,
          f"monitor demo: replay {rows.shape}, {cubes} kernel voxels")
    return launches


# the depth render on the card (float32) against the CPU (float64): a ray
# stops advancing once the ESDF at its tip is ≤ render_depth's hit_eps
# (1e-2 m); where the two precisions fall on either side of it, one more
# step of about hit_eps separates their depths, plus float32 rounding along
# the ray (measured: 0.010008 m)
DEPTH_ATOL = 1e-2 + 1e-4


def phase_sim(pm, dev):
    """sim/ and goals on the card: render_depth at 640 × 480 (90° field of
    view, 96 steps) over the ESDF of phase 3's map, held against the same
    render on the CPU in float64 (hit masks equal on ≥ 99.5 % of the
    pixels, depth within DEPTH_ATOL where both hit); a 1,000-step closed loop
    of so3_control → force_moments_to_rpm → step holding a hover within
    1e-3 m; sample_free_goals on the card equal to the CPU's → record."""
    from dataclasses import replace

    import torch
    from isdf_torch import sim
    from isdf_torch.plan import sample_free_goals
    from isdf_torch.sim.quadrotor import force_moments_to_rpm

    gm = pm.gridmap.with_esdf()
    gm_cpu = replace(gm.cpu(), esdf=gm.esdf.double().cpu())
    cam = sim.CameraIntrinsics.from_fov(640, 480, 90.0)
    # from the map's west edge, level, looking east across the blocks
    # (camera z forward, x right, y down: columns −y, −z, +x of the world)
    pos = np.array([2.0, 25.0, 7.0])
    R = np.stack([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]],
                 axis=1)
    depth = sim.render_depth(gm, cam, pos, R)
    ms = cuda_ms(lambda: sim.render_depth(gm, cam, pos, R), warmup=1,
                 reps=5)
    ref = sim.render_depth(gm_cpu, cam, pos, R).numpy()
    d = depth.double().cpu().numpy()
    hit, hit_ref = d < 20.0, ref < 20.0
    both = hit & hit_ref
    agree = float((hit == hit_ref).mean())
    diff = np.abs(d - ref)[both]
    err = float(diff.max()) if both.any() else 0.0

    p = sim.QuadrotorParams()
    hover = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, device=dev)
    s = sim.QuadState.hover(p, pos=hover, device=dev)
    zero = torch.zeros(3, dtype=torch.float64, device=dev)
    worst = torch.zeros((), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    for _ in range(1000):
        thrust, M = sim.so3_control(s.pos, s.vel, s.R, s.omega, hover, zero,
                                    zero, 0.0, p.mass, p.g,
                                    inertia=p.inertia)
        s = sim.quad_step(s, force_moments_to_rpm(thrust, M, p), p, dt=0.01)
        worst = torch.maximum(worst, torch.linalg.norm(s.pos - hover))
    worst = float(worst)
    loop_s = time.perf_counter() - t0

    goals_card = sample_free_goals(gm, 16, seed=0)
    goals_cpu = sample_free_goals(gm_cpu, 16, seed=0)
    rec = dict(depth_ms=ms, pixels=cam.width * cam.height,
               hit_share=float(hit.mean()), hit_agree=agree,
               max_depth_err=err,
               depth_err_over_1cm=int((diff > 1e-2).sum()),
               hover_steps=1000,
               hover_max_drift_m=worst, hover_loop_s=loop_s,
               goals_equal=bool(np.array_equal(goals_card, goals_cpu)))
    print("sim " + json.dumps(rec), flush=True)
    check(hit.any(), "sim: the depth render hit nothing")
    check(agree >= 0.995, f"sim: hit masks agree on {agree:.4f} of pixels")
    check(err <= DEPTH_ATOL,
          f"sim: depth differs by {err!r} m from the CPU's")
    check(worst <= 1e-3, f"sim: the hover drifted {worst:.3g} m")
    check(rec["goals_equal"], "sim: sample_free_goals differs from the CPU")
    return rec


# the cli as a user runs it (isdf_tpu/cli.py's flags), each run in its own
# process on the card
CLI_RUNS = (
    ("demo 1", ["demo", "1", "--iters", "200", "--swept-mesh", "--view"]),
    ("demo 6", ["demo", "6", "--iters", "200", "--swept-mesh", "--view"]),
    ("demo 8", ["demo", "8"]),
    ("closed-loop", ["closed-loop", "--max-time", "9"]),
)
SCENE_LAYERS = ["map voxels", "A* path", "trajectory", "poses",
                "swept volume"]


def phase_cli(ref_root: str, workdir: str) -> dict:
    """`python3 -m isdf_torch.cli` as a user runs it, with the stand-in
    reference checkout as $ISDF_REFERENCE_ROOT, the four runs at once (each
    wall is then one of four processes sharing the card and the host): each
    run must exit 0 and write the files the JAX package's cli writes for its
    flags → {label: record}."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    from isdf_torch.shapes.mesh import load_obj

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ISDF_REFERENCE_ROOT=ref_root)

    def run(label, args):
        dest = os.path.join(workdir, "cli", label.replace(" ", "_"))
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "isdf_torch.cli", *args, "--out",
                 dest], cwd=here, env=env, capture_output=True, text=True,
                timeout=300)
        except subprocess.TimeoutExpired:
            return label, args, dest, None, 300.0
        return label, args, dest, proc, time.perf_counter() - t0

    # the runs share the card and the host, all started together
    with ThreadPoolExecutor(len(CLI_RUNS)) as pool:
        runs = list(pool.map(lambda r: run(*r), CLI_RUNS))
    out = {}
    for label, args, dest, proc, wall in runs:
        check(proc is not None, f"cli {label}: no exit within 300 s")
        check(proc.returncode == 0,
              f"cli {label}: exit {proc.returncode}: {proc.stderr[-3000:]}")
        with open(os.path.join(dest, "metrics.json")) as f:
            m = json.load(f)
        rec = dict(run=label, args=args, rc=proc.returncode,
                   wall_s_four_at_once=wall, files=sorted(os.listdir(dest)))
        if label == "closed-loop":
            rec.update({k: m[k] for k in ("reached", "replans",
                                          "min_body_sdf", "replan_p50_s")})
            check(m["reached"] and m["min_body_sdf"] > 0.0,
                  f"cli {label}: {m}")
            check("flight.csv" in rec["files"], f"cli {label}: no flight.csv")
        else:
            rec.update(success=m["success"],
                       min_swept_sdf=m.get("min_swept_sdf"),
                       final_cost=m.get("final_cost"),
                       plan_wall_s=m["wall_s"])
            check(m["success"] and m.get("min_swept_sdf", -1.0) > 0.0,
                  f"cli {label}: success {m['success']}, min swept SDF "
                  f"{m.get('min_swept_sdf')!r}")
        if "--swept-mesh" in args:
            V, F = load_obj(os.path.join(dest, "swept_volume.obj"))
            with open(os.path.join(dest, "scene.html")) as f:
                data = json.loads(re.search(r"const DATA = (\{.*?\});\n",
                                            f.read(), re.S).group(1))
            layers = [L["name"] for L in data["layers"]]
            rec.update(triangles=int(len(F)), scene_layers=layers)
            check(len(F) > 0 and len(V) == 3 * len(F)
                  and m["swept_mesh_tris"] == len(F),
                  f"cli {label}: swept_volume.obj has {len(V)} vertices, "
                  f"{len(F)} triangles")
            check(layers == SCENE_LAYERS, f"cli {label}: layers {layers}")
            check({"trajectory.csv", "astar_path.csv"} <= set(rec["files"]),
                  f"cli {label}: files {rec['files']}")
        print("cli " + json.dumps(rec), flush=True)
        out[label] = rec
    return out


# the bench (isdf_torch/bench.py) as a user runs it, in its own process; its
# record's keys are the JAX bench's (bench.py:292-316, the roofline's vpu_*
# renamed fp32_*) and the port's own
BENCH_TIMEOUT_S = 600
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_ref_desktop_est",
    "ref_evals_per_s_measured", "sweep_point_queries_per_s",
    "flops_per_query", "fp32_tflops", "fp32_util", "sweep_mqps_spread",
    "plans_per_s_per_chip", "plans_per_s_audited", "grid_queries_per_s",
    "plans_scaling", "plans_scaling_spread", "peak_host_rss_mb",
    "peak_device_mb", "p50_plan_latency_ms", "plan_latency_pipelined_ms",
    "p50_device_ms", "plan_iters", "device", "card", "launches",
    "finite_scenarios")
BENCH_BASELINE = ("vs_baseline", "vs_ref_desktop_est",
                  "ref_evals_per_s_measured")
# the one kernel each section of the bench launches
BENCH_KERNELS = {"sweep": "K1", "audited": "K2", "grid": "K3",
                 "latency": "K1"}


def phase_bench() -> dict:
    """`python3 -m isdf_torch.cli bench` in its own process: it must exit 0
    and print as its last line the record with every key, null baseline
    fields, positive finite rates, times and memory, every scenario of
    every solve finite, and each section's launches of its kernel alone
    (counted by the bench from its own start) → the record."""
    import torch
    from isdf_torch import bench

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "isdf_torch.cli", "bench"], cwd=here,
            capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"bench: no exit within {BENCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"bench: exit {proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    print("bench: " + json.dumps(rec), flush=True)
    print(f"bench: the process took {wall:.2f} s", flush=True)
    missing = [k for k in BENCH_KEYS if k not in rec]
    check(not missing, f"bench: keys missing {missing}")
    check(all(rec[k] is None for k in BENCH_BASELINE),
          "bench: a baseline field is not null")
    sizes = bench.BenchSizes()
    Bs = [str(B) for B in sizes.batch_sizes]
    check(sorted(rec["plans_scaling"]) == sorted(Bs)
          and sorted(rec["plans_scaling_spread"]) == sorted(Bs),
          f"bench: plans_scaling over {sorted(rec['plans_scaling'])}")
    rates = [rec[k] for k in (
        "value", "sweep_point_queries_per_s", "flops_per_query",
        "fp32_tflops", "fp32_util", "plans_per_s_per_chip",
        "plans_per_s_audited", "grid_queries_per_s", "peak_host_rss_mb",
        "peak_device_mb", "p50_plan_latency_ms", "plan_latency_pipelined_ms",
        "p50_device_ms")] + rec["sweep_mqps_spread"] + [
        v for B in Bs for v in [rec["plans_scaling"][B],
                                *rec["plans_scaling_spread"][B]]]
    check(all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
              for v in rates), f"bench: a rate, time or size is not "
                               f"positive and finite: {rates}")
    want = {**{B: int(B) for B in Bs}, "audited": sizes.audit_B}
    check(rec["finite_scenarios"] == want,
          f"bench: finite scenarios {rec['finite_scenarios']}, not {want}")
    launches = rec["launches"]
    sections = {**{k: launches[k] for k in BENCH_KERNELS},
                **{f"plans_scaling {B}": launches["plans_scaling"][B]
                   for B in Bs}}
    for name, counts in sections.items():
        kernel = BENCH_KERNELS.get(name, "K2")
        check(list(counts) == [kernel] and counts[kernel] > 0,
              f"bench: section {name} launched {counts}, not {kernel} alone")
    if not os.environ.get("ISDF_PROFILE"):
        want = 1 + sizes.sweep_repeats * sizes.sweep_calls
        check(launches["sweep"]["K1"] == want,
              f"bench: {launches['sweep']['K1']} K1 launches in the sweep "
              f"section, not {want}")
    check(launches["grid"]["K3"] == 1 + sizes.grid_calls,
          f"bench: {launches['grid']['K3']} K3 launches in the grid section")
    check(rec["device"] == torch.cuda.get_device_name(0),
          f"bench: device {rec['device']!r}")
    return rec


def phase_volume_kernels(dev, pm, traj, pm_mesh, traj_mesh):
    """K1 and K3 at the swept-volume mesh's launch, after the profiler
    traces: the first 65,536-voxel chunk of demo 1's volume (RoundedCone
    posed, cold, coarse 128, rounds 24, one lane a point) and of demo 6's
    (the L field, cold), each against its plain version: t* and d* bitwise
    (K3 also the gradient), K1's gradient in its band → records.  Demo 6's
    volume holds fewer voxels than a chunk (its one launch is that size);
    its case extends the same 0.25 m lattice along x, past the goal, to
    65,536 points."""
    import torch
    from isdf_torch.viz import swept_mesh

    recs = {}
    kw = dict(coarse_n=128, rounds=24, warm_window=0.3)
    for label, man, tr in (("K1", pm, traj), ("K3", pm_mesh, traj_mesh)):
        tr = tr.detach()
        origin, size = swept_mesh._auto_bounds(tr, man.shape, SWEPT_RES)
        if math.prod(size) < SWEPT_CHUNK:
            size = (-(-SWEPT_CHUNK // (size[1] * size[2])),) + size[1:]
        pts = torch.as_tensor(
            swept_mesh.grid_points(origin, size, SWEPT_RES)[:SWEPT_CHUNK],
            dtype=torch.float32, device=dev).contiguous()
        cold = torch.zeros_like(pts[:, 0])
        if label == "K1":
            args = kernel_inputs(torch, tr, man.params, pts, cold, 128)
            rec = hold_k1(man.shape, man.params, args, kw, "volume65536")
            exact = rec["t_equal"] == 1.0 and rec["d_equal"] == 1.0
        else:
            durs = tr.durations.contiguous()
            args = (pts, cold, (torch.cumsum(durs, 0) - durs).contiguous(),
                    durs, tr.coeffs.contiguous())
            rec = hold_k3(man.shape.grid, man.params, args, kw,
                          "L/volume65536")
            exact = (rec["t_equal"] == 1.0 and rec["d_equal"] == 1.0
                     and rec["grad_equal"] == 1.0)
        check_kernel(exact, f"{label} volume65536: not bitwise equal to its "
                            f"plain version ({rec})")
        recs[label] = rec
    return recs


# seconds each phase took, printed as it ends and once more at the end
PHASE_S = {}


def timed_phase(fn, *args):
    """fn(*args), its seconds kept in PHASE_S under the phase's name."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        name = fn.__name__.removeprefix("phase_")
        PHASE_S[name] = time.perf_counter() - t0
        print(f"{name}: the phase took {PHASE_S[name]:.1f} s", flush=True)


def kernel_line(name, replaces, launches, max_abs_err, rec, pose, paths,
                source="isdf_torch/csrc/sweep_warm.cu", case=None):
    """One kernel and pose map of the kernels line: ``launches`` the sum of
    the counts its paths read (``paths``: {path: launches}); ``case`` names
    the shape of a bench entry, whose numbers are those of its case."""
    line = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "pose": pose,
        "launches": launches, "launches_by_path": paths,
        "max_abs_err": max_abs_err, "ms": rec["ms"],
        "call_ms": rec["call_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None,
    }
    if case is not None:
        line["case"] = case
    return line


def bench_lines(bench_rec, k1_recs, k2_recs, k3_recs) -> list:
    """The kernels line's entries of the bench's shapes: each with its case's
    numbers and the launches the bench's section made at that shape."""
    L = bench_rec["launches"]
    k1 = {r["size"]: r for r in k1_recs if r["shape"] == "CappedCone"}
    k2 = {r["case"]: r for r in k2_recs if "case" in r}
    k3 = {r["case"]: r for r in k3_recs}
    # K2's case at each B of the bench's scaling
    k2_case = {"128": "B128", "512": "B512/first", "2048": "B2048/first",
               "4096": "B4096"}
    cases = [
        ("sweep_warm_fused", ":419", k1["bench"], "sweep P = 32768",
         {"cli bench: sweep": L["sweep"]["K1"]}),
        ("sweep_warm_fused", ":419", k1["latency512"],
         "latency solve P = 512",
         {"cli bench: latency": L["latency"]["K1"]}),
        *(("sweep_warm_fused_batched", ":458", k2[k2_case[B]],
           f"plans_scaling B = {B}",
           {f"cli bench: plans_scaling {B}": n["K2"]})
          for B, n in L["plans_scaling"].items()),
        ("sweep_warm_fused_batched", ":458", k2["B128/audit"],
         "audited B = 128, audit coarse 512",
         {"cli bench: audited": L["audited"]["K2"]}),
    ]
    lines = [kernel_line(name, "isdf_tpu/sweep/pallas_zoom.py" + line,
                         sum(paths.values()), rec["max_abs_d"], rec, "flat",
                         paths, case=case)
             for name, line, rec, case, paths in cases]
    lines.append(kernel_line(
        "grid_sweep_warm_fused", "isdf_tpu/sweep/pallas_grid_zoom.py:314",
        L["grid"]["K3"], k3["torus64/bench"]["max_abs_d"],
        k3["torus64/bench"], "flat", {"cli bench: grid": L["grid"]["K3"]},
        source="isdf_torch/csrc/grid_sweep.cu", case="grid torus 64³"))
    return lines


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
        PHASE_S["build"] = time.perf_counter() - t0
        print(f"build: K1, K2 and K4 for {len(libs) - 1} body-SDF kinds, "
              f"and K3 ({len(libs)} libraries, built in parallel) in "
              f"{PHASE_S['build']:.2f} s", flush=True)
        # what ptxas reports: [kernel, registers, spill stores, spill loads
        # (bytes), stack frame (bytes)] per library
        print("build: ptxas " + json.dumps({
            label: [list(r) for r in fused_zoom.ptxas_report(lib)]
            for label, lib in libs.items()}), flush=True)
        obj_path = write_l_robot(workdir.name)
        # the demos' assets: read by isdf_torch.demos when it is imported
        ref_root = write_reference_root(workdir.name, obj_path)
        os.environ["ISDF_REFERENCE_ROOT"] = ref_root
        # the timed paths first, the kernel phase's profiler traces after
        plan_m, k1_launches, pm, traj, solve1 = timed_phase(phase_plan, dev)
        k4_launches = timed_phase(phase_refine, pm, traj)
        k2_launches, batch_case, batch_solved = timed_phase(phase_batch, dev)
        multi = timed_phase(phase_multidevice, batch_solved, obj_path)
        _, k3_launches, pm_mesh, traj_mesh = timed_phase(
            phase_mesh_plan, dev, obj_path)
        timed_phase(phase_mesh_batch, dev, pm_mesh.shape)
        planar = timed_phase(phase_planar, dev)
        fly = timed_phase(phase_fly, dev)
        planar_paths = timed_phase(phase_planar_paths, dev, planar, obj_path)
        k1_lmbm = timed_phase(phase_lmbm, pm, solve1)
        k1_golden = timed_phase(phase_golden, dev)
        k1_monitor = timed_phase(phase_monitor, pm, plan_m, solve1)
        timed_phase(phase_non_fused, pm, traj, pm_mesh, traj_mesh, obj_path)
        k1_demos = timed_phase(phase_run_demo, planar)
        swept = timed_phase(phase_swept, pm, traj, pm_mesh, traj_mesh)
        k1_monitor_demo = timed_phase(phase_monitor_demo, workdir.name, dev)
        timed_phase(phase_sim, pm, dev)
        timed_phase(phase_cli, ref_root, workdir.name)
        bench_rec = timed_phase(phase_bench)
        k1_recs, slice_case = timed_phase(phase_kernels, dev)
        k2_recs = timed_phase(phase_k2, dev)
        k4_recs = timed_phase(phase_k4, dev, slice_case)
        k3_recs = timed_phase(phase_k3, dev, obj_path)
        planar_recs = timed_phase(phase_planar_kernels, dev, planar, obj_path)
        volume_recs = timed_phase(
            phase_volume_kernels, dev, pm, traj, pm_mesh, traj_mesh)
        check(not KERNEL_FAILURES, "; ".join(KERNEL_FAILURES))
        if "--profile" in sys.argv[1:]:
            phase_profile(pm, batch_case, pm_mesh, planar, dev)
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
    # Under the planar map: K1 at demo 8's size, its launches from the two
    # planar demos; K2, K4 and K3 at their planar cases, their launches from
    # the entry points of phase_planar_paths.
    k1_main = next(r for r in k1_recs
                   if r["size"] == "slice" and r["shape"] == "RoundedCone")
    k2_main = next(r for r in k2_recs if r.get("ms") and r["B"] == 128)
    k4_main = next(r for r in k4_recs if r["shape"] == "RoundedCone")
    k3_main = next(r for r in k3_recs if r["case"] == "L/slice")
    k1_planar = planar_recs["K1"][0]
    k1_paths = {"PlannerManager.plan demo 1": k1_launches,
                "fly_closed_loop": fly["k1_launches"],
                **{f"backend.optimize {k} demo 1": v
                   for k, v in k1_lmbm.items()},
                "backend.optimize reference goldens": k1_golden,
                "PlannerManager.plan(monitor=) demo 1": k1_monitor,
                "run_demo(1, monitor=)": k1_monitor_demo,
                "swept_mesh": swept["demo 1 RoundedCone"]["launches"]}
    k3_paths = {"PlannerManager.plan demo 6": k3_launches,
                "swept_mesh": swept["demo 6 L"]["launches"], **multi["K3"]}
    k2_paths = {"batched_solve_chunked B = 128": k2_launches, **multi["K2"]}
    multi_err = {k: max(c["max_abs_d"] for c in multi["cases"]
                        if c["kernel"] == k) for k in ("K2", "K3")}
    k1p_paths = {**{f"plan_planar {k}": v["k1_launches"]
                    for k, v in planar.items()},
                 **{f"run_demo({k})": v for k, v in k1_demos.items()}}
    kernels = [
        kernel_line("sweep_warm_fused", "isdf_tpu/sweep/pallas_zoom.py:419",
                    sum(k1_paths.values()),
                    max(r["max_abs_d"] for r in k1_recs
                        + [volume_recs["K1"]]), k1_main, "flat", k1_paths),
        kernel_line("sweep_warm_fused", "isdf_tpu/sweep/pallas_zoom.py:419",
                    sum(k1p_paths.values()),
                    max(r["max_abs_d"] for r in planar_recs["K1"]),
                    k1_planar, "planar", k1p_paths),
        kernel_line("sweep_warm_fused_batched",
                    "isdf_tpu/sweep/pallas_zoom.py:458",
                    sum(k2_paths.values()),
                    max(k2_main["max_abs_d"], multi_err["K2"]), k2_main,
                    "flat", k2_paths),
        kernel_line("sweep_warm_fused_batched",
                    "isdf_tpu/sweep/pallas_zoom.py:458", planar_paths["K2"],
                    planar_recs["K2"][0]["max_abs_d"], planar_recs["K2"][0],
                    "planar", {"sweep_sdf_warm B = 8": planar_paths["K2"]}),
        kernel_line("zoom_refine", "isdf_tpu/sweep/pallas_zoom.py:245",
                    k4_launches, max(r["max_abs_d"] for r in k4_recs),
                    k4_main, "flat", {"zoom_refine": k4_launches}),
        kernel_line("zoom_refine", "isdf_tpu/sweep/pallas_zoom.py:245",
                    planar_paths["K4"], planar_recs["K4"][0]["max_abs_d"],
                    planar_recs["K4"][0], "planar",
                    {"zoom_refine": planar_paths["K4"]}),
        kernel_line("grid_sweep_warm_fused",
                    "isdf_tpu/sweep/pallas_grid_zoom.py:314",
                    sum(k3_paths.values()),
                    max([r["max_abs_d"] for r in k3_recs
                         + [volume_recs["K3"]]] + [multi_err["K3"]]),
                    k3_main, "flat", k3_paths,
                    source="isdf_torch/csrc/grid_sweep.cu"),
        kernel_line("grid_sweep_warm_fused",
                    "isdf_tpu/sweep/pallas_grid_zoom.py:314",
                    planar_paths["K3"], planar_recs["K3"][0]["max_abs_d"],
                    planar_recs["K3"][0], "planar",
                    {"audit_planar": planar_paths["K3"]},
                    source="isdf_torch/csrc/grid_sweep.cu"),
        *bench_lines(bench_rec, k1_recs, k2_recs, k3_recs),
    ]
    print("phases: seconds " + json.dumps(PHASE_S), flush=True)
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
