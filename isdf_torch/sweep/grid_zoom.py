"""K3 — the swept-SDF kernel of mesh robots, whose body SDF is a baked voxel
field — and its plain PyTorch version (counterpart of
``isdf_tpu/sweep/pallas_grid.py`` and ``isdf_tpu/sweep/pallas_grid_zoom.py``).

* ``GridField``: the device-side field of a grid shape — the true field in
  float32, x-major (nx, ny, nz), its 2×-min-pooled twin and the ten geometry
  numbers of both; built once, with the shape, on the shape's device;
* ``grid_sweep_warm_fused`` (K3, ``pallas_grid_zoom.grid_sweep_warm_fused``):
  the fused warm sweep of one trajectory → (t*, d*, ∂SDF/∂p_rel at t*);
* ``grid_sweep_warm_fused_batched``: the same over a leading scenario axis B,
  every scenario on the one field, one launch (the TPU runs one launch per
  scenario under ``vmap``).

Per query point, as the TPU kernel computes it: a coarse scan of
``coarse_n`` samples on the pooled twin, a 2-round warm pre-zoom (k = 4)
from t_warm, one true-field evaluation at the coarse argmin, the seed pick,
one deep zoom of ``rounds`` rounds (k = 4, shrink 2/3) on the true field, and
the trilinear value and its analytic gradient at t*.  Each wrapper, on CUDA
tensors, launches the hand-written kernel in ``isdf_torch/csrc/grid_sweep.cu``
or raises; on CPU tensors it runs its ``*_ref``, the same function in
PyTorch operations.  ``LAUNCHES_GRID`` counts kernel launches.

The TPU kernel keeps the field in bf16 and turns the trilinear lookup into a
two-hot MXU product (the TPU has no vector gather).  On the card a direct
8-corner gather is the natural form, so the field stays float32 and the
bf16 rounding is gone; the pooled search of fields beyond the TPU's VMEM
budget is gone too: K3 reads fields of any size from global memory.
"""

from __future__ import annotations

import ctypes
import itertools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from isdf_torch.core.smoothing import clip
from isdf_torch.sweep import fused_zoom
from isdf_torch.sweep.fast_eval import (
    pose_components, pvaj_tables, rel_components)

# kernel launches since the caller last set it to 0 (single and batched)
LAUNCHES_GRID = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "grid_sweep.cu"
ZOOM_K = 4        # zoom candidates per round
SCAN_K = 8        # coarse-scan group: coarse_n must be a multiple of it
PRE_ROUNDS = 2    # rounds of the warm pre-zoom
LANES = ZOOM_K    # threads per query point in the kernel: one a candidate

_lib: Optional[ctypes.CDLL] = None


@dataclass(frozen=True, eq=False)
class GridField:
    """A baked SDF field on its device, as K3 and its plain version read it.

    ``field`` (nx, ny, nz) float32, flat index (ix·ny + iy)·nz + iz;
    ``pooled`` its 2×2×2 min-pooled twin (odd dimensions edge-padded first):
    pooled cell i covers voxels {2i, 2i+1}, so its sample point sits at
    origin + (2i + ½)·res.  ``geo``: origin, 1/res, res of the field, then
    of the twin (origin + res/2, 1/(2·res), 2·res), computed in double as
    the TPU wrapper does (pallas_grid_zoom.py:461-465)."""

    field: torch.Tensor
    pooled: torch.Tensor
    origin: Tuple[float, float, float]
    res: float
    geo: Tuple[float, ...]

    @classmethod
    def build(cls, field, origin, res, device) -> "GridField":
        f = torch.as_tensor(field, dtype=torch.float32,
                            device=device).contiguous()
        if f.dim() != 3 or min(f.shape) < 3:
            raise ValueError(f"field {tuple(f.shape)}: need (nx, ny, nz), "
                             "each at least 3")
        fe = f
        for ax in range(3):
            if fe.shape[ax] % 2:
                fe = torch.cat([fe, fe.narrow(ax, fe.shape[ax] - 1, 1)], ax)
        nx2, ny2, nz2 = (n // 2 for n in fe.shape)
        pooled = fe.reshape(nx2, 2, ny2, 2, nz2, 2).amin(
            dim=(1, 3, 5)).contiguous()
        o = tuple(float(v) for v in np.asarray(origin, np.float64))
        r = float(res)
        geo = (o[0], o[1], o[2], 1.0 / r, r,
               o[0] + 0.5 * r, o[1] + 0.5 * r, o[2] + 0.5 * r,
               1.0 / (2.0 * r), 2.0 * r)
        return cls(f, pooled, o, r, geo)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.field.shape)

    @property
    def pooled_dims(self) -> Tuple[int, int, int]:
        return tuple(self.pooled.shape)

    @property
    def device(self) -> torch.device:
        return self.field.device


def _w_seed_a(warm_window: float) -> float:
    """The deep zoom's window after the warm pre-zoom wins: the pre-zoom's
    window shrunk PRE_ROUNDS times by 2/(k − 1), in double."""
    return warm_window * (2.0 / (ZOOM_K - 1)) ** PRE_ROUNDS


def _upper(n: int) -> float:
    """The clamp's upper bound on a grid coordinate, (n − 1) − 1e-5."""
    return (n - 1) - 1e-5


# ---------------------------------------------------------------------------
# the kernel

class _GridFieldC(ctypes.Structure):
    _fields_ = [("f", ctypes.c_void_p), ("nx", ctypes.c_int),
                ("ny", ctypes.c_int), ("nz", ctypes.c_int),
                ("ox", ctypes.c_float), ("oy", ctypes.c_float),
                ("oz", ctypes.c_float), ("inv_res", ctypes.c_float),
                ("res", ctypes.c_float), ("hx", ctypes.c_float),
                ("hy", ctypes.c_float), ("hz", ctypes.c_float)]


def _field_c(f: torch.Tensor, geo5) -> _GridFieldC:
    n = f.shape
    return _GridFieldC(f.data_ptr(), *n, *geo5, *(_upper(m) for m in n))


def build_jobs():
    """The compile job of K3's library: (label, source, defines, output)."""
    tag = fused_zoom.source_tag(SOURCE)
    return [("K3", SOURCE, [], fused_zoom.BUILD_DIR / f"grid_sweep_{tag}.so")]


def build():
    """Compile K3's library unless it is built for this source version →
    its path."""
    return fused_zoom.compile_jobs(build_jobs())["K3"]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.isdf_grid_sweep_warm_fused
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2
                       + [_GridFieldC, _GridFieldC, fused_zoom._PoseArgsC,
                          ctypes.c_void_p])
        _lib = lib
    return _lib


def _check_args(params, pts, t_warm, starts, durs, coeffs, coarse_n):
    """The pose map, and the shapes of the sweep's arguments with any
    leading scenario axis."""
    fused_zoom.check_pose_map(params)
    lead = tuple(pts.shape[:-2])
    P = pts.shape[-2]
    N = durs.shape[-1]
    if coarse_n < SCAN_K or coarse_n % SCAN_K:
        raise ValueError(f"coarse_n must be a multiple of {SCAN_K}")
    if pts.shape != lead + (P, 3) or t_warm.shape != lead + (P,):
        raise ValueError(f"pts {tuple(pts.shape)} / t_warm "
                         f"{tuple(t_warm.shape)}: expected {lead + ('P', 3)} "
                         f"/ {lead + ('P',)}")
    if (durs.shape != lead + (N,) or starts.shape != lead + (N,)
            or coeffs.shape[:-2] != lead + (N,)):
        raise ValueError("starts/durs/coeffs disagree on the piece count")
    fused_zoom.check_smem(N, coarse_n)
    return P, N


def _launch(grid: GridField, params, pts, t_warm, starts, durs, coeffs, B, P,
            N, coarse_n, rounds, warm_window):
    """One launch of grid_sweep_kernel over B scenarios → (t*, d*, grad)."""
    ins = dict(pts=pts, t_warm=t_warm, starts=starts, durs=durs,
               coeffs=coeffs, field=grid.field, pooled=grid.pooled)
    for name, t in ins.items():
        if not t.is_cuda or t.device != pts.device:
            raise ValueError(f"{name} must lie on {pts.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if coeffs.shape[-2:] != (fused_zoom.N_COEF, 3):
        raise ValueError(f"coeffs {tuple(coeffs.shape)}: the kernel takes "
                         f"(..., N, {fused_zoom.N_COEF}, 3)")
    if not 1 <= N <= fused_zoom.MAX_PIECES or rounds < 1:
        raise ValueError(f"need 1 <= N <= {fused_zoom.MAX_PIECES} and "
                         "rounds >= 1")
    t_star = torch.empty(t_warm.shape, dtype=torch.float32, device=pts.device)
    d_star = torch.empty_like(t_star)
    grad = torch.empty(pts.shape, dtype=torch.float32, device=pts.device)
    if B * P == 0:
        return t_star, d_star, grad, False
    fused_zoom.check_blocks(B, P, LANES)
    err = _load().isdf_grid_sweep_warm_fused(
        pts.data_ptr(), t_warm.data_ptr(), starts.data_ptr(),
        durs.data_ptr(), coeffs.data_ptr(), t_star.data_ptr(),
        d_star.data_ptr(), grad.data_ptr(), B, P, N, coarse_n, rounds,
        float(warm_window), _w_seed_a(warm_window),
        _field_c(grid.field, grid.geo[:5]),
        _field_c(grid.pooled, grid.geo[5:]), fused_zoom.pose_args_c(params),
        fused_zoom._stream(pts.device))
    if err != 0:
        raise RuntimeError(
            f"grid sweep kernel launch failed: CUDA error {err}")
    return t_star, d_star, grad, True


def grid_sweep_warm_fused(grid: GridField, params, pts, t_warm, starts, durs,
                          coeffs, coarse_n: int = 64, rounds: int = 12,
                          warm_window: float = 0.3):
    """K3.  Fused warm grid sweep → (t* (P,), d* (P,), grad_prel (P, 3)).

    d* and grad_prel are the trilinear value and its gradient at t*, which
    callers linearise (sweep_sdf.sweep_value).  CUDA tensors launch the
    kernel (float32, contiguous, on the field's card); CPU tensors run
    :func:`grid_sweep_warm_fused_ref`."""
    global LAUNCHES_GRID
    if pts.dim() != 2:
        raise ValueError(f"pts {tuple(pts.shape)}: expected (P, 3)")
    P, N = _check_args(params, pts, t_warm, starts, durs, coeffs,
                       coarse_n)
    if not pts.is_cuda:
        return grid_sweep_warm_fused_ref(grid, params, pts, t_warm, starts,
                                         durs, coeffs, coarse_n, rounds,
                                         warm_window)
    t_star, d_star, grad, launched = _launch(
        grid, params, pts, t_warm, starts, durs, coeffs, 1, P, N, coarse_n,
        rounds, warm_window)
    LAUNCHES_GRID += launched
    return t_star, d_star, grad


def grid_sweep_warm_fused_batched(grid: GridField, params, pts, t_warm,
                                  starts, durs, coeffs, coarse_n: int = 64,
                                  rounds: int = 12, warm_window: float = 0.3):
    """K3 over B scenarios in one launch → (t* (B, P), d* (B, P), grad_prel
    (B, P, 3)).  pts (B, P, 3), t_warm (B, P), starts and durs (B, N),
    coeffs (B, N, 6, 3); every scenario reads the one field.  CPU tensors
    run :func:`grid_sweep_warm_fused_batched_ref`."""
    global LAUNCHES_GRID
    if pts.dim() != 3:
        raise ValueError(f"pts {tuple(pts.shape)}: expected (B, P, 3)")
    P, N = _check_args(params, pts, t_warm, starts, durs, coeffs,
                       coarse_n)
    if not pts.is_cuda:
        return grid_sweep_warm_fused_batched_ref(
            grid, params, pts, t_warm, starts, durs, coeffs, coarse_n, rounds,
            warm_window)
    t_star, d_star, grad, launched = _launch(
        grid, params, pts, t_warm, starts, durs, coeffs, pts.shape[0], P, N,
        coarse_n, rounds, warm_window)
    LAUNCHES_GRID += launched
    return t_star, d_star, grad


# ---------------------------------------------------------------------------
# the plain PyTorch version

def _field_eval(f, geo5, rx, ry, rz, with_grad=False):
    """The field's clamped trilinear value plus the outside-box distance at
    body-frame points, in the kernel's order of operations; with
    ``with_grad`` also ∂/∂p_rel in closed form, (…, 3).

    f: the field in the working dtype; geo5: (ox, oy, oz, 1/res, res) as
    tensors of that dtype on its device."""
    o = geo5[:3]
    inv_res, res = geo5[3], geo5[4]
    dims = f.shape
    flat = f.reshape(-1)
    gs = [(r - oc) * inv_res for r, oc in zip((rx, ry, rz), o)]
    his = [torch.full((), _upper(n), dtype=f.dtype, device=f.device)
           for n in dims]
    idx, frac = [], []
    for g, n, hi in zip(gs, dims, his):
        gc = clip(g, 0.0, hi)
        i0 = torch.clamp(torch.floor(gc).to(torch.int64), 0, n - 2)
        idx.append(i0)
        frac.append(gc - i0.to(g.dtype))
    fx, fy, fz = frac
    sx, sy = dims[1] * dims[2], dims[2]
    base = (idx[0] * dims[1] + idx[1]) * dims[2] + idx[2]
    f000, f100 = flat[base], flat[base + sx]
    f010, f110 = flat[base + sy], flat[base + sx + sy]
    f001, f101 = flat[base + 1], flat[base + sx + 1]
    f011, f111 = flat[base + sy + 1], flat[base + sx + sy + 1]
    ux, uy, uz = 1 - fx, 1 - fy, 1 - fz
    c00 = f000 * ux + f100 * fx
    c10 = f010 * ux + f110 * fx
    c01 = f001 * ux + f101 * fx
    c11 = f011 * ux + f111 * fx
    c0 = c00 * uy + c10 * fy
    c1 = c01 * uy + c11 * fy
    inner = c0 * uz + c1 * fz
    ov = [torch.clamp_min(g - (n - 1), 0.0) + torch.clamp_max(g, 0.0)
          for g, n in zip(gs, dims)]
    ov2 = ov[0] * ov[0] + ov[1] * ov[1] + ov[2] * ov[2]
    outside = torch.sqrt(ov2 * (res * res) + 1e-12)
    d = inner + outside
    if not with_grad:
        return d
    # ∂inner/∂g: the y-then-z lerp of the corner differences along x, and
    # likewise for y and z; zero where the clamp holds g (strict masks)
    dx0 = (f100 - f000) * uy + (f110 - f010) * fy
    dx1 = (f101 - f001) * uy + (f111 - f011) * fy
    di = (dx0 * uz + dx1 * fz, (c10 - c00) * uz + (c11 - c01) * fz, c1 - c0)
    oslope = (res * res) / outside
    grad = [(dig * ((g > 0.0) & (g < hi)).to(g.dtype) + ovg * oslope)
            * inv_res for dig, g, hi, ovg in zip(di, gs, his, ov)]
    return d, torch.stack(grad, dim=-1)


@torch.no_grad()
def grid_sweep_warm_fused_ref(grid: GridField, params, pts, t_warm, starts,
                              durs, coeffs, coarse_n: int = 64,
                              rounds: int = 12, warm_window: float = 0.3):
    """K3's function in PyTorch operations, in any dtype (the field and the
    geometry are cast to it): the coarse scan on the pooled twin in the TPU
    kernel's tie order, the warm pre-zoom, the true-field evaluation at the
    coarse argmin, the seed pick with its branch-dependent window, the deep
    zoom, and the closed-form value and gradient at t*."""
    dtype, dev = pts.dtype, pts.device
    P = pts.shape[0]
    geo = [torch.full((), v, dtype=dtype, device=dev) for v in grid.geo]
    fine = grid.field.to(dev, dtype)
    pooled = grid.pooled.to(dev, dtype)
    pw = (pts[:, 0], pts[:, 1], pts[:, 2])
    cum = torch.stack(list(itertools.accumulate(durs.unbind())))  # in order
    total = cum[-1]
    step = total / torch.full_like(total, coarse_n - 1)   # a true division

    def rel_at(t):
        pos, vel, acc = pvaj_tables(starts, durs, cum, coeffs, t)
        x3, R = pose_components(pos, vel, acc, params)
        return rel_components(pw, x3, R)

    def sdf_fine(rx, ry, rz):
        return _field_eval(fine, geo[:5], rx, ry, rz)

    # coarse scan on the pooled twin; the kernel keeps, per row r = j mod 8,
    # the first group with a strictly smaller value, then the first row:
    # the first minimum in row-major order of (r, j // 8)
    tcol = clip(torch.arange(coarse_n, dtype=dtype, device=dev) * step, 0.0,
                total)
    pos, vel, acc = pvaj_tables(starts, durs, cum, coeffs, tcol)
    x3, R = pose_components(pos, vel, acc, params)
    d = _field_eval(pooled, geo[5:], *rel_components(
        pw, tuple(c[:, None] for c in x3), tuple(c[:, None] for c in R)))
    order = torch.arange(coarse_n, device=dev).reshape(-1, SCAN_K).T \
        .reshape(-1)
    t0 = tcol[order[torch.argmin(d[order], dim=0)]]

    def zoom(t, w, n):
        return fused_zoom._zoom_ref(sdf_fine, params, pw, starts, durs, cum,
                                    coeffs, t, w, n, ZOOM_K)

    tA, dA = zoom(clip(t_warm, 0.0, total),
                  torch.full((P,), warm_window, dtype=dtype, device=dev),
                  PRE_ROUNDS)
    use_a = dA <= sdf_fine(*rel_at(t0))
    t_seed = torch.where(use_a, tA, t0)
    w_seed = torch.where(
        use_a, torch.full_like(tA, _w_seed_a(warm_window)),
        step.expand(P))
    t_star, _ = zoom(t_seed, w_seed, rounds)
    d_star, grad = _field_eval(fine, geo[:5], *rel_at(t_star), with_grad=True)
    return t_star, d_star, grad


def grid_sweep_warm_fused_batched_ref(grid: GridField, params, pts, t_warm,
                                      starts, durs, coeffs,
                                      coarse_n: int = 64, rounds: int = 12,
                                      warm_window: float = 0.3):
    """The batched K3's function in PyTorch operations:
    :func:`grid_sweep_warm_fused_ref` on each scenario in turn."""
    outs = [grid_sweep_warm_fused_ref(grid, params, pts[b], t_warm[b],
                                      starts[b], durs[b], coeffs[b], coarse_n,
                                      rounds, warm_window)
            for b in range(pts.shape[0])]
    if not outs:
        return (torch.empty_like(t_warm), torch.empty_like(t_warm),
                torch.empty_like(pts))
    return tuple(torch.stack(o) for o in zip(*outs))
