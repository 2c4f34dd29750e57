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
(shapes/spec.py), and loaded through plain C entry points.  ``LAUNCHES``,
``LAUNCHES_BATCHED`` and ``LAUNCHES_ZOOM`` count kernel launches.

Only t* leaves the sweep kernels as a result the optimizer uses; callers
re-evaluate SDF(p, t*) differentiably outside (envelope theorem).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

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
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
N_COEF = 6            # the kernels' piece degree (MINCO s = 3)
MAX_PIECES = 256      # keeps the per-block tables under 48 KB of shared memory

_libs: Dict[int, ctypes.CDLL] = {}


class _ShapeSpecC(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("posed", ctypes.c_int),
                ("p", ctypes.c_float * MAX_PARAMS),
                ("R", ctypes.c_float * 9), ("t", ctypes.c_float * 3)]


class _FlatArgsC(ctypes.Structure):
    _fields_ = [("grav", ctypes.c_float), ("kd", ctypes.c_float),
                ("cp", ctypes.c_float), ("veps", ctypes.c_float)]


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


def compile_jobs(jobs) -> Dict[str, Path]:
    """Compile every job whose library is not yet built, one nvcc process
    each, all started together → {label: library path}."""
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
                       + [ctypes.c_float, _ShapeSpecC, _FlatArgsC,
                          ctypes.c_void_p])
        fn = lib.isdf_zoom_refine
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [_ShapeSpecC, _FlatArgsC, ctypes.c_void_p])
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


def _flat_c(params) -> _FlatArgsC:
    return _FlatArgsC(params.grav, params.dh / params.mass, params.cp,
                      params.veps)


def _check_sweep_args(pts, t_warm, pose_table, starts, durs, coeffs,
                      coarse_n, k):
    """Shapes of the sweep's arguments, with any leading scenario axis."""
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
    return P, N


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


def _launch_sweep(shape, params, pts, t_warm, pose_table, starts, durs,
                  coeffs, B, P, N, coarse_n, rounds, warm_window):
    """One launch of sweep_warm_kernel over B scenarios → (t*, d*, grad)."""
    _check_cuda_inputs(shape, dict(pts=pts, t_warm=t_warm,
                                   pose_table=pose_table, starts=starts,
                                   durs=durs, coeffs=coeffs), coeffs, N,
                       rounds)
    t_star = torch.empty(t_warm.shape, dtype=torch.float32, device=pts.device)
    d_star = torch.empty_like(t_star)
    grad = torch.empty(pts.shape, dtype=torch.float32, device=pts.device)
    if B * P == 0:
        return t_star, d_star, grad, False
    if B * ((P + 127) // 128) > 2 ** 31 - 1:
        raise ValueError(f"B = {B} scenarios of P = {P} points exceed the "
                         "2^31 - 1 blocks of one launch; split the batch")
    err = _load(shape.spec.kind).isdf_sweep_warm_fused(
        pts.data_ptr(), t_warm.data_ptr(), pose_table.data_ptr(),
        starts.data_ptr(), durs.data_ptr(), coeffs.data_ptr(),
        t_star.data_ptr(), d_star.data_ptr(), grad.data_ptr(),
        B, P, N, coarse_n, rounds, float(warm_window), _spec_c(shape.spec),
        _flat_c(params), _stream(pts.device))
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
    P, N = _check_sweep_args(pts, t_warm, pose_table, starts, durs, coeffs,
                             coarse_n, k)
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
    P, N = _check_sweep_args(pts, t_warm, pose_table, starts, durs, coeffs,
                             coarse_n, k)
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
        _spec_c(shape.spec), _flat_c(params), _stream(pts.device))
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
