"""K1, the fused warm swept-SDF kernel, and its plain PyTorch version
(counterpart of ``isdf_tpu/sweep/pallas_zoom.py:sweep_warm_fused``).

``sweep_warm_fused`` is the wrapper: on CUDA tensors it launches the
hand-written kernel in ``isdf_torch/csrc/sweep_warm.cu`` (built with nvcc at
first use into ``isdf_torch/_build/`` and loaded through a plain C entry
point), or raises; on CPU tensors it runs ``sweep_warm_fused_ref``, the same
function written with PyTorch operations (same candidate lattice, tie rule
and branch pick).  ``LAUNCHES`` counts kernel launches.

Only t* leaves the kernel as a result the optimizer uses; callers
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

import torch

from isdf_torch.core.smoothing import clip
from isdf_torch.shapes.spec import MAX_PARAMS
from isdf_torch.sweep.fast_eval import (
    pose_components, pvaj_tables, rel_components)

LAUNCHES = 0          # kernel launches since the caller last set it to 0

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "sweep_warm.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false: the kernel rounds op by op as its plain version does (see the
# note in sweep_warm.cu); no --use_fast_math
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
N_COEF = 6            # the kernel's piece degree (MINCO s = 3)
MAX_PIECES = 256      # keeps the per-block tables under 48 KB of shared memory

_lib = None


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
        raise RuntimeError("nvcc not found: the K1 sweep kernel is built "
                           "from isdf_torch/csrc/sweep_warm.cu at first use")
    return exe


def build() -> Path:
    """Compile the kernel library (once per source version) → its path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"sweep_warm_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.isdf_sweep_warm_fused
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4
                       + [ctypes.c_float, _ShapeSpecC, _FlatArgsC,
                          ctypes.c_void_p])
        _lib = lib
    return _lib


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


def _check_args(pts, t_warm, pose_table, starts, durs, coeffs, coarse_n, k):
    P = pts.shape[0]
    N = durs.shape[0]
    if k != 8:
        raise ValueError("the sweep kernel zooms with k = 8 candidates")
    if coarse_n % k:
        raise ValueError("coarse_n must be a multiple of k")
    if pts.shape != (P, 3) or t_warm.shape != (P,):
        raise ValueError(f"pts {tuple(pts.shape)} / t_warm "
                         f"{tuple(t_warm.shape)}: expected (P, 3) / (P,)")
    if pose_table.shape != (coarse_n, 12):
        raise ValueError(f"pose table {tuple(pose_table.shape)}, expected "
                         f"({coarse_n}, 12)")
    if starts.shape != (N,) or coeffs.shape[0] != N:
        raise ValueError("starts/durs/coeffs disagree on the piece count")
    return P, N


def sweep_warm_fused(shape, params, pts, t_warm, pose_table, starts, durs,
                     coeffs, coarse_n: int = 64, rounds: int = 12, k: int = 8,
                     warm_window: float = 0.3):
    """Fused warm sweep → (t* (P,), d* (P,), grad_prel (P, 3)).

    d* is the non-differentiable SDF at t* (branch pick, diagnostics).
    pose_table: (coarse_n, 12) rows [x, y, z, R00..R22] at the uniform coarse
    times (sweep_sdf.traj_states).  CUDA tensors launch the kernel (float32,
    contiguous); CPU tensors run :func:`sweep_warm_fused_ref`."""
    global LAUNCHES
    P, N = _check_args(pts, t_warm, pose_table, starts, durs, coeffs,
                       coarse_n, k)
    if not pts.is_cuda:
        return sweep_warm_fused_ref(shape, params, pts, t_warm, pose_table,
                                    starts, durs, coeffs, coarse_n, rounds, k,
                                    warm_window)
    if shape.spec is None:
        raise NotImplementedError(
            f"shape {shape.name!r} has no device SDF for the CUDA sweep "
            "kernel (shapes/spec.py)")
    ins = dict(pts=pts, t_warm=t_warm, pose_table=pose_table, starts=starts,
               durs=durs, coeffs=coeffs)
    for name, t in ins.items():
        if not t.is_cuda or t.device != pts.device:
            raise ValueError(f"{name} must lie on {pts.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coeffs.shape[1:] != (N_COEF, 3):
        raise ValueError(f"coeffs {tuple(coeffs.shape)}: the kernel takes "
                         f"(N, {N_COEF}, 3)")
    if not 1 <= N <= MAX_PIECES or rounds < 1:
        raise ValueError(f"need 1 <= N <= {MAX_PIECES} and rounds >= 1")
    t_star = torch.empty(P, dtype=torch.float32, device=pts.device)
    d_star = torch.empty_like(t_star)
    grad = torch.empty((P, 3), dtype=torch.float32, device=pts.device)
    if P == 0:
        return t_star, d_star, grad
    lib = _load()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.isdf_sweep_warm_fused(
        pts.data_ptr(), t_warm.data_ptr(), pose_table.data_ptr(),
        starts.data_ptr(), durs.data_ptr(), coeffs.data_ptr(),
        t_star.data_ptr(), d_star.data_ptr(), grad.data_ptr(),
        P, N, coarse_n, rounds, float(warm_window), _spec_c(shape.spec),
        _flat_c(params), stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t_star, d_star, grad


# ---------------------------------------------------------------------------
# plain PyTorch version of the kernel
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

    shrink = 2.0 / (k - 1)
    offs = torch.arange(k, dtype=dtype, device=dev)[:, None] * shrink - 1.0

    def zoom(t, w):
        dm = None
        for _ in range(rounds):
            cand = clip(t[None, :] + w[None, :] * offs, 0.0, total)
            pos, vel, acc = pvaj_tables(starts, durs, cum, coeffs, cand)
            xs, Rs = pose_components(pos, vel, acc, params)
            dd = sdf3(*rel_components(pw, xs, Rs))
            t, dm = _plateau_rows(dd, cand)
            w = w * shrink
        return t, dm

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
