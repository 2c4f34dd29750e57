"""K1, K2 and K4 — the analytic-shape swept-SDF kernels — and their plain
PyTorch versions (counterpart of ``isdf_tpu/sweep/pallas_zoom.py``).

* ``sweep_warm_fused`` (K1, ``pallas_zoom.sweep_warm_fused``): the fused warm
  sweep of one trajectory;
* ``sweep_warm_fused_batched`` (K2, the scenario-batched launch that JAX
  reaches through ``jax.vmap``): the same over a leading scenario axis B, one
  launch for all scenarios;
* ``zoom_refine`` (K4, ``pallas_zoom.zoom_refine``): the fixed-round plateau
  zoom alone.

Each wrapper, on CUDA tensors, launches the hand-written kernel in
``isdf_torch/csrc/sweep_warm.cu`` or raises; on CPU tensors it runs its
``*_ref``, the same function written with PyTorch operations (same candidate
lattice, tie rule and branch pick).  The source is compiled with nvcc at
first use into ``isdf_torch/_build/``, one library per body-SDF kind
(shapes/spec.py), and loaded through plain C entry points; the registers and
spills ptxas reports for each kernel are kept beside the library
(:func:`ptxas_report`).  ``LAUNCHES``, ``LAUNCHES_BATCHED`` and
``LAUNCHES_ZOOM`` count kernel launches.

A launch gives each query point one thread or several (one per zoom
candidate, the sweep's two zooms side by side), by its size alone
(:func:`_lanes_for`): the single-trajectory sweeps leave most of the card
idle with one thread a point, the large batched sweep fills it.  Every lane
count is an instantiation of the one kernel and gives bitwise the same
results.

Every kernel takes either pose map of core/flatness, as the TPU kernels
take theirs through ``params``: the quadrotor tilt (``FlatParams``) or SE(2)
(``PlanarPose``, the planar planner's: the trajectory's third axis is the
yaw).  Both are instantiated in every library; ``pose_args_c`` tells the C
entry point which one to launch.

Only t* leaves the sweep kernels as a result the optimizer uses; callers
re-evaluate SDF(p, t*) differentiably outside (envelope theorem).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core.smoothing import clip
from isdf_torch.shapes.spec import KINDS, MAX_PARAMS
from isdf_torch.sweep.fast_eval import (
    pose_components, pvaj_tables, rel_components)

# kernel launches since the caller last set them to 0
LAUNCHES = 0            # K1, sweep_warm_fused
LAUNCHES_BATCHED = 0    # K2, sweep_warm_fused_batched
LAUNCHES_ZOOM = 0       # K4, zoom_refine

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "sweep_warm.cu"
HEADER = _PKG / "csrc" / "pose_chain.cuh"     # included by every source
BUILD_DIR = _PKG / "_build"
# -fmad=false: the kernels round op by op as their plain versions do (see the
# note in sweep_warm.cu); no --use_fast_math
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
N_COEF = 6            # the kernels' piece degree (MINCO s = 3)
MAX_PIECES = 256      # pieces of one trajectory the kernels take
SMEM_MAX = 232448     # shared memory of one block on sm_90 (227 KB)
TABLE_FLOATS = 3 * 8 + 2 + 1   # a piece in shared memory (pose_chain.cuh)
BLOCK = 128           # threads per block
ZOOM_LANES = 8        # K4's threads a point on a small launch: one a candidate
SWEEP_LANES = 16      # K1/K2's: zoom A and zoom B side by side
# K1/K2/K4 launches of at most this many points take several threads a
# point, larger ones one: the crossing measured on an H100 (PERF.md §6)
LANES_MAX_POINTS = 16384

_libs: Dict[int, ctypes.CDLL] = {}


class _ShapeSpecC(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("posed", ctypes.c_int),
                ("p", ctypes.c_float * MAX_PARAMS),
                ("R", ctypes.c_float * 9), ("t", ctypes.c_float * 3)]


class _PoseArgsC(ctypes.Structure):
    """The pose map as the C entry points take it (pose_chain.cuh
    PoseArgs): ``planar`` 0 with the tilt constants, or 1 with z_ref."""
    _fields_ = [("planar", ctypes.c_int), ("grav", ctypes.c_float),
                ("kd", ctypes.c_float), ("cp", ctypes.c_float),
                ("veps", ctypes.c_float), ("z_ref", ctypes.c_float)]


def _lanes_for(B: int, P: int) -> int:
    """Threads per query point of a K1/K2 launch of B scenarios × P points:
    SWEEP_LANES while B·P ≤ LANES_MAX_POINTS, where one thread a point
    leaves SMs idle, else 1.  K4 takes ZOOM_LANES where this takes more
    than one."""
    return SWEEP_LANES if B * P <= LANES_MAX_POINTS else 1


def sweep_smem_bytes(N: int, coarse_n: int) -> int:
    """Shared memory of one block of the sweep kernels: the coarse pose
    table (12 floats a row) and N pieces' tables."""
    return 4 * (12 * coarse_n + TABLE_FLOATS * N)


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the sweep kernels are built "
                           "from isdf_torch/csrc/ at first use")
    return exe


def source_tag(source: Path) -> str:
    """Version of a kernel source: its bytes, the shared header's and the
    compiler flags."""
    blob = source.read_bytes() + HEADER.read_bytes() + " ".join(
        NVCC_FLAGS).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


def build_jobs(kinds: Optional[Iterable[int]] = None):
    """The compile jobs of the K1/K2/K4 libraries: one (label, source,
    defines, output) per body-SDF kind in ``kinds`` (default: all)."""
    tag = source_tag(SOURCE)
    return [(f"kind {k}", SOURCE, [f"-DSDF_KIND={k}"],
             BUILD_DIR / f"sweep_warm_k{k}_{tag}.so")
            for k in (KINDS if kinds is None else kinds)]


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _template_args(mangled: str):
    """The template arguments of a mangled kernel name's ``I…E`` list:
    integers (``Li16E``) and class names (``8FlatArgs``)."""
    args, i = [], 1
    if not mangled.startswith("I"):
        return args
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"Li(\d+)E", mangled[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
            continue
        m = re.match(r"(\d+)", mangled[i:])
        if not m:
            break
        n = int(m.group(1))
        args.append(mangled[i + m.end():i + m.end() + n])
        i += m.end() + n
    return args


def ptxas_report(lib: Path):
    """What ptxas said of each kernel of a built library → [(kernel,
    registers, spill-store bytes, spill-load bytes, stack bytes)], the
    kernel as ``name<template arguments>`` (the pose map by its struct,
    ``FlatArgs`` or ``PlanarArgs``)."""
    out, name, frame = [], None, None
    path = _report_path(lib)
    for line in path.read_text().splitlines() if path.exists() else ():
        m = re.search(r"Compiling entry function '(_Z\d+)?(\w+?)'", line)
        if m:
            mangled = m.group(2)
            n = int(m.group(1)[2:]) if m.group(1) else len(mangled)
            args = _template_args(mangled[n:])
            name = mangled[:n] + (f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            st, sl = (frame[1], frame[2]) if frame else (0, 0)
            out.append((name, int(m.group(1)), st, sl,
                        frame[0] if frame else 0))
            name, frame = None, None
    return out


def compile_jobs(jobs) -> Dict[str, Path]:
    """Compile every job whose library is not yet built, one nvcc process
    each, all started together → {label: library path}.  What ptxas
    reports of a library's kernels is written beside it
    (:func:`ptxas_report`)."""
    out = {label: lib for label, _, _, lib in jobs}
    todo = [j for j in jobs if not j[3].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for label, source, defines, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs.append((label, source, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *defines, "-o", tmp, str(source)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for label, source, lib, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{source.name}, {label}:\n{err}")
            else:
                os.replace(tmp, lib)
                _report_path(lib).write_text(err)
        if errors:
            raise RuntimeError("nvcc failed to build " + "\n".join(errors))
    finally:
        for _, _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def build(kinds: Optional[Iterable[int]] = None) -> Dict[int, Path]:
    """Compile the kernel library of every kind in ``kinds`` (default: all)
    that is not yet built for this source version → {kind: path}.  One nvcc
    process per kind, all started together."""
    kinds = tuple(KINDS if kinds is None else kinds)
    libs = compile_jobs(build_jobs(kinds))
    return {k: libs[f"kind {k}"] for k in kinds}


def _load(kind: int) -> ctypes.CDLL:
    lib = _libs.get(kind)
    if lib is None:
        lib = ctypes.CDLL(str(build([kind])[kind]))
        lib.isdf_sdf_kind.restype = ctypes.c_int
        lib.isdf_sdf_kind.argtypes = []
        if lib.isdf_sdf_kind() != kind:
            raise RuntimeError(f"kernel library built for kind "
                               f"{lib.isdf_sdf_kind()}, wanted {kind}")
        fn = lib.isdf_sweep_warm_fused
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, _ShapeSpecC,
                          _PoseArgsC, ctypes.c_void_p])
        fn = lib.isdf_zoom_refine
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [_ShapeSpecC, _PoseArgsC, ctypes.c_void_p])
        _libs[kind] = lib
    return lib


def _spec_c(spec) -> _ShapeSpecC:
    s = _ShapeSpecC()
    s.kind = spec.kind
    s.posed = int(spec.posed)
    for i, v in enumerate(spec.params):
        s.p[i] = v
    for i, v in enumerate(spec.R):
        s.R[i] = v
    for i, v in enumerate(spec.t):
        s.t[i] = v
    return s


def check_pose_map(params) -> None:
    """The kernels take the two pose maps of core/flatness and no other."""
    if not isinstance(params, fl.POSE_MAPS):
        raise TypeError(f"pose map {type(params).__name__}: the sweep "
                        "kernels take FlatParams or PlanarPose")


def pose_args_c(params) -> _PoseArgsC:
    """The pose map's C struct: PlanarPose → (1, z_ref), FlatParams → (0,
    g, dh/m, cp, veps)."""
    check_pose_map(params)
    if isinstance(params, fl.PlanarPose):
        return _PoseArgsC(planar=1, z_ref=params.z_ref)
    return _PoseArgsC(planar=0, grav=params.grav,
                      kd=params.dh / params.mass, cp=params.cp,
                      veps=params.veps)


def _check_sweep_args(params, pts, t_warm, pose_table, starts, durs, coeffs,
                      coarse_n, k):
    """The pose map, and the shapes of the sweep's arguments with any
    leading scenario axis."""
    check_pose_map(params)
    lead = tuple(pts.shape[:-2])
    P = pts.shape[-2]
    N = durs.shape[-1]
    if k != 8:
        raise ValueError("the sweep kernel zooms with k = 8 candidates")
    if coarse_n % k:
        raise ValueError("coarse_n must be a multiple of k")
    if pts.shape != lead + (P, 3) or t_warm.shape != lead + (P,):
        raise ValueError(f"pts {tuple(pts.shape)} / t_warm "
                         f"{tuple(t_warm.shape)}: expected {lead + ('P', 3)} "
                         f"/ {lead + ('P',)}")
    if pose_table.shape != lead + (coarse_n, 12):
        raise ValueError(f"pose table {tuple(pose_table.shape)}, expected "
                         f"{lead + (coarse_n, 12)}")
    if (durs.shape != lead + (N,) or starts.shape != lead + (N,)
            or coeffs.shape[:-2] != lead + (N,)):
        raise ValueError("starts/durs/coeffs disagree on the piece count")
    check_smem(N, coarse_n)
    return P, N


def check_smem(N: int, coarse_n: int) -> None:
    """The kernels stage the pose table and the piece tables of a scenario
    in one block's shared memory: refuse what does not fit."""
    if sweep_smem_bytes(N, coarse_n) > SMEM_MAX:
        raise ValueError(f"coarse_n = {coarse_n} with N = {N} pieces needs "
                         f"{sweep_smem_bytes(N, coarse_n)} bytes of shared "
                         f"memory, more than a block's {SMEM_MAX}")


def _check_cuda_inputs(shape, ins, coeffs, N, rounds):
    """What the kernels take: a device SDF, float32 contiguous tensors on
    one card, quintic pieces."""
    if shape.spec is None:
        raise NotImplementedError(
            f"shape {shape.name!r} has no device SDF for the CUDA sweep "
            "kernels (shapes/spec.py)")
    dev = next(iter(ins.values())).device
    for name, t in ins.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must lie on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coeffs.shape[-2:] != (N_COEF, 3):
        raise ValueError(f"coeffs {tuple(coeffs.shape)}: the kernels take "
                         f"(..., N, {N_COEF}, 3)")
    if not 1 <= N <= MAX_PIECES or rounds < 1:
        raise ValueError(f"need 1 <= N <= {MAX_PIECES} and rounds >= 1")


def _stream(dev) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def check_blocks(B: int, P: int, lanes: int) -> None:
    """A launch's one-dimensional grid holds at most 2^31 − 1 blocks."""
    per = BLOCK // lanes
    if B * ((P + per - 1) // per) > 2 ** 31 - 1:
        raise ValueError(f"B = {B} scenarios of P = {P} points exceed the "
                         "2^31 - 1 blocks of one launch; split the batch")


def _launch_sweep(shape, params, pts, t_warm, pose_table, starts, durs,
                  coeffs, B, P, N, coarse_n, rounds, warm_window):
    """One launch of sweep_warm_kernel over B scenarios → (t*, d*, grad)."""
    _check_cuda_inputs(shape, dict(pts=pts, t_warm=t_warm,
                                   pose_table=pose_table, starts=starts,
                                   durs=durs, coeffs=coeffs), coeffs, N,
                       rounds)
    if pose_table.data_ptr() % 16:
        raise ValueError("pose_table must be 16-byte aligned")
    t_star = torch.empty(t_warm.shape, dtype=torch.float32, device=pts.device)
    d_star = torch.empty_like(t_star)
    grad = torch.empty(pts.shape, dtype=torch.float32, device=pts.device)
    if B * P == 0:
        return t_star, d_star, grad, False
    lanes = _lanes_for(B, P)
    check_blocks(B, P, lanes)
    err = _load(shape.spec.kind).isdf_sweep_warm_fused(
        pts.data_ptr(), t_warm.data_ptr(), pose_table.data_ptr(),
        starts.data_ptr(), durs.data_ptr(), coeffs.data_ptr(),
        t_star.data_ptr(), d_star.data_ptr(), grad.data_ptr(),
        B, P, N, coarse_n, rounds, float(warm_window), lanes,
        _spec_c(shape.spec), pose_args_c(params), _stream(pts.device))
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    return t_star, d_star, grad, True


def sweep_warm_fused(shape, params, pts, t_warm, pose_table, starts, durs,
                     coeffs, coarse_n: int = 64, rounds: int = 12, k: int = 8,
                     warm_window: float = 0.3):
    """K1.  Fused warm sweep → (t* (P,), d* (P,), grad_prel (P, 3)).

    d* is the non-differentiable SDF at t* (branch pick, diagnostics).
    pose_table: (coarse_n, 12) rows [x, y, z, R00..R22] at the uniform coarse
    times (sweep_sdf.traj_states).  CUDA tensors launch the kernel (float32,
    contiguous); CPU tensors run :func:`sweep_warm_fused_ref`."""
    global LAUNCHES
    if pts.dim() != 2:
        raise ValueError(f"pts {tuple(pts.shape)}: expected (P, 3)")
    P, N = _check_sweep_args(params, pts, t_warm, pose_table, starts, durs,
                             coeffs, coarse_n, k)
    if not pts.is_cuda:
        return sweep_warm_fused_ref(shape, params, pts, t_warm, pose_table,
                                    starts, durs, coeffs, coarse_n, rounds, k,
                                    warm_window)
    t_star, d_star, grad, launched = _launch_sweep(
        shape, params, pts, t_warm, pose_table, starts, durs, coeffs, 1, P,
        N, coarse_n, rounds, warm_window)
    LAUNCHES += launched
    return t_star, d_star, grad


def sweep_warm_fused_batched(shape, params, pts, t_warm, pose_table, starts,
                             durs, coeffs, coarse_n: int = 64,
                             rounds: int = 12, k: int = 8,
                             warm_window: float = 0.3):
    """K2.  The fused warm sweep of B scenarios in one launch →
    (t* (B, P), d* (B, P), grad_prel (B, P, 3)).

    pts (B, P, 3), t_warm (B, P), pose_table (B, coarse_n, 12), starts and
    durs (B, N), coeffs (B, N, 6, 3): every scenario has its own points,
    trajectory and pose table (so its own total duration and coarse step);
    N and coarse_n are shared.  CUDA tensors launch the kernel once for all
    scenarios; CPU tensors run :func:`sweep_warm_fused_batched_ref`."""
    global LAUNCHES_BATCHED
    if pts.dim() != 3:
        raise ValueError(f"pts {tuple(pts.shape)}: expected (B, P, 3)")
    P, N = _check_sweep_args(params, pts, t_warm, pose_table, starts, durs,
                             coeffs, coarse_n, k)
    if not pts.is_cuda:
        return sweep_warm_fused_batched_ref(
            shape, params, pts, t_warm, pose_table, starts, durs, coeffs,
            coarse_n, rounds, k, warm_window)
    t_star, d_star, grad, launched = _launch_sweep(
        shape, params, pts, t_warm, pose_table, starts, durs, coeffs,
        pts.shape[0], P, N, coarse_n, rounds, warm_window)
    LAUNCHES_BATCHED += launched
    return t_star, d_star, grad


def zoom_refine(shape, params, pts, t0, w0, starts, durs, coeffs,
                rounds: int = 12, k: int = 8):
    """K4.  Fixed-round plateau zoom: (pts (P, 3), t0 (P,), w0 (P,)) → t*
    (P,).  Each round evaluates k candidates t + w·(2i/(k−1) − 1), clipped to
    [0, total], re-centres t on the plateau-centred argmin and shrinks w by
    2/(k−1).  CUDA tensors launch the kernel; CPU tensors run
    :func:`zoom_refine_ref`."""
    global LAUNCHES_ZOOM
    check_pose_map(params)
    P, N = pts.shape[0], durs.shape[0]
    if k != 8:
        raise ValueError("the zoom kernel zooms with k = 8 candidates")
    if pts.shape != (P, 3) or t0.shape != (P,) or w0.shape != (P,):
        raise ValueError(f"pts {tuple(pts.shape)} / t0 {tuple(t0.shape)} / "
                         f"w0 {tuple(w0.shape)}: expected (P, 3) / (P,) / "
                         "(P,)")
    if starts.shape != (N,) or coeffs.shape[0] != N:
        raise ValueError("starts/durs/coeffs disagree on the piece count")
    if not pts.is_cuda:
        return zoom_refine_ref(shape, params, pts, t0, w0, starts, durs,
                               coeffs, rounds, k)
    _check_cuda_inputs(shape, dict(pts=pts, t0=t0, w0=w0, starts=starts,
                                   durs=durs, coeffs=coeffs), coeffs, N,
                       rounds)
    t_star = torch.empty(P, dtype=torch.float32, device=pts.device)
    if P == 0:
        return t_star
    err = _load(shape.spec.kind).isdf_zoom_refine(
        pts.data_ptr(), t0.data_ptr(), w0.data_ptr(), starts.data_ptr(),
        durs.data_ptr(), coeffs.data_ptr(), t_star.data_ptr(), P, N, rounds,
        ZOOM_LANES if _lanes_for(1, P) > 1 else 1, _spec_c(shape.spec),
        pose_args_c(params), _stream(pts.device))
    if err != 0:
        raise RuntimeError(f"zoom kernel launch failed: CUDA error {err}")
    LAUNCHES_ZOOM += 1
    return t_star


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def _plateau_rows(d, cand, tie_eps: float = 1e-4):
    """Plateau-centred argmin over the k candidate rows of (k, P) arrays:
    the mean of the connected near-minimum run around the first argmin."""
    k = d.shape[0]
    dmin = d.min(dim=0, keepdim=True).values
    eps = tie_eps * torch.clamp(dmin.abs(), min=1.0)
    tie = d <= dmin + eps
    j = torch.argmin(d, dim=0, keepdim=True)          # first index of the min
    idx = torch.arange(k, device=d.device)[:, None]
    conn_r = torch.cumprod((tie | (idx <= j)).to(d.dtype), dim=0)
    conn_l = torch.flip(torch.cumprod(
        torch.flip((tie | (idx >= j)).to(d.dtype), [0]), dim=0), [0])
    conn = torch.where(idx >= j, conn_r, conn_l)
    tsum = torch.zeros_like(cand[0])
    for i in range(k):                  # in row order, as the kernel adds
        tsum = tsum + conn[i] * cand[i]
    t = tsum / conn.sum(dim=0)
    return t, dmin[0]


def _zoom_ref(sdf3, params, pw, starts, durs, cum, coeffs, t, w, rounds, k):
    """`rounds` rounds of the k-candidate plateau zoom from (t, w) (P,) →
    (t*, the last round's minimum)."""
    total = cum[-1]
    shrink = 2.0 / (k - 1)
    offs = torch.arange(k, dtype=t.dtype, device=t.device)[:, None] * shrink \
        - 1.0
    dm = None
    for _ in range(rounds):
        cand = clip(t[None, :] + w[None, :] * offs, 0.0, total)
        pos, vel, acc = pvaj_tables(starts, durs, cum, coeffs, cand)
        xs, Rs = pose_components(pos, vel, acc, params)
        dd = sdf3(*rel_components(pw, xs, Rs))
        t, dm = _plateau_rows(dd, cand)
        w = w * shrink
    return t, dm


@torch.no_grad()
def sweep_warm_fused_ref(shape, params, pts, t_warm, pose_table, starts, durs,
                         coeffs, coarse_n: int = 64, rounds: int = 12,
                         k: int = 8, warm_window: float = 0.3):
    """The kernel's function in PyTorch operations, for any zoo shape (through
    its ``sdf3``) and any dtype: coarse scan in the kernel's order, the two
    plateau zooms, the dA <= dB pick, and the autograd gradient at t*."""
    sdf3 = shape.sdf3_fn()
    dtype, dev = pts.dtype, pts.device
    P = pts.shape[0]
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    cum = torch.stack(list(itertools.accumulate(durs.unbind())))  # in order
    total = cum[-1]
    # a true division, as in the kernel: on CUDA, dividing by a Python number
    # multiplies by its float reciprocal, which can differ by an ulp
    step = total / torch.full_like(total, coarse_n - 1)

    # coarse scan: row r = j mod k outer, group j // k inner, first minimum
    order = torch.arange(coarse_n, device=dev).reshape(-1, k).T.reshape(-1)
    rows = pose_table[order]
    x3 = tuple(rows[:, c:c + 1] for c in range(3))
    R = tuple(rows[:, 3 + c:4 + c] for c in range(9))
    d = sdf3(*rel_components(pw, x3, R))               # (coarse_n, P)
    t0 = order[torch.argmin(d, dim=0)].to(dtype) * step

    def zoom(t, w):
        return _zoom_ref(sdf3, params, pw, starts, durs, cum, coeffs, t, w,
                         rounds, k)

    tA, dA = zoom(clip(t_warm, 0.0, total),
                  torch.full((P,), warm_window, dtype=dtype, device=dev))
    tB, dB = zoom(t0, step.expand(P))
    use_a = dA <= dB
    t_star = torch.where(use_a, tA, tB)
    d_star = torch.where(use_a, dA, dB)

    pos, vel, acc = pvaj_tables(starts, durs, cum, coeffs, t_star)
    xs, Rs = pose_components(pos, vel, acc, params)
    prel = rel_components(pw, xs, Rs)
    with torch.enable_grad():
        q = [c.detach().requires_grad_(True) for c in prel]
        g = torch.autograd.grad(sdf3(*q).sum(), q, allow_unused=True)
    g = [torch.zeros_like(c) if gi is None else gi for gi, c in zip(g, q)]
    return t_star, d_star, torch.stack(g, dim=-1)


def sweep_warm_fused_batched_ref(shape, params, pts, t_warm, pose_table,
                                 starts, durs, coeffs, coarse_n: int = 64,
                                 rounds: int = 12, k: int = 8,
                                 warm_window: float = 0.3):
    """K2's function in PyTorch operations: :func:`sweep_warm_fused_ref` on
    each scenario in turn (the scenarios are independent)."""
    outs = [sweep_warm_fused_ref(shape, params, pts[b], t_warm[b],
                                 pose_table[b], starts[b], durs[b], coeffs[b],
                                 coarse_n, rounds, k, warm_window)
            for b in range(pts.shape[0])]
    if not outs:
        return (torch.empty_like(t_warm), torch.empty_like(t_warm),
                torch.empty_like(pts))
    return tuple(torch.stack(o) for o in zip(*outs))


@torch.no_grad()
def zoom_refine_ref(shape, params, pts, t0, w0, starts, durs, coeffs,
                    rounds: int = 12, k: int = 8):
    """K4's function in PyTorch operations, for any zoo shape and dtype."""
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    cum = torch.stack(list(itertools.accumulate(durs.unbind())))  # in order
    t, _ = _zoom_ref(shape.sdf3_fn(), params, pw, starts, durs, cum, coeffs,
                     t0, w0, rounds, k)
    return t
