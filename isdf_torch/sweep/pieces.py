"""K5 — the trajectory's position, velocity and acceleration at given times,
with their gradient, as one hand-written CUDA kernel pair
(``isdf_torch/csrc/pieces.cu``), and its plain PyTorch versions.

:func:`pvaj_at` is what the swept SDF's differentiable value at t* reads
(``sweep_sdf.sweep_value``).  On CUDA tensors it launches the kernel's
forward, and autograd its backward, or raises; on the CPU it runs
``fast_eval.pvaj_tables``, the plain version of the forward.  The forward is
bitwise ``pvaj_tables`` on the card; the backward forms each time's
gradient with respect to its piece's row (the 18 coefficients, the start and
the duration through the clip) and sums it per piece in a fixed order, with
no sort and no float atomics.  :func:`pvaj_backward_ref` is that backward in
PyTorch operations.

The library is built with the sweep kernels' flags into
``isdf_torch/_build/`` at first use (``fused_zoom.compile_jobs``) and loaded
through plain C entry points.  ``LAUNCHES`` and ``LAUNCHES_BACKWARD`` count
the forward's and the backward's launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from isdf_torch.core.poly import take_pieces
from isdf_torch.core.smoothing import clip
from isdf_torch.sweep import fused_zoom
from isdf_torch.sweep.fast_eval import piece_index, piece_tables, pvaj_tables

# launches since the caller last set them to 0
LAUNCHES = 0             # forward
LAUNCHES_BACKWARD = 0    # backward (both passes)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pieces.cu"
VALUES = 20              # a piece row's gradient: 18 coefficients, start, duration
TILE = 128               # times a block of the backward's first pass (pieces.cu)
_DTYPES = {torch.float32: 0, torch.float64: 1}

_lib: Optional[ctypes.CDLL] = None


class _NineC(ctypes.Structure):
    """Nine pointers (pieces.cu ``Nine``): pos, vel, acc of x, y, z."""
    _fields_ = [("p", ctypes.c_void_p * 9)]


def build_jobs():
    """The compile job of K5's library: (label, source, defines, output)."""
    tag = fused_zoom.source_tag(SOURCE)
    return [("K5", SOURCE, [], fused_zoom.BUILD_DIR / f"pieces_{tag}.so")]


def build():
    """Compile K5's library unless it is built for this source version →
    its path."""
    return fused_zoom.compile_jobs(build_jobs())["K5"]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.isdf_pieces_tile.restype = ctypes.c_int
        lib.isdf_pieces_tile.argtypes = []
        if lib.isdf_pieces_tile() != TILE:
            raise RuntimeError(f"K5 library built with a tile of "
                               f"{lib.isdf_pieces_tile()}, wanted {TILE}")
        fn = lib.isdf_pieces_forward
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [_NineC] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn = lib.isdf_pieces_backward
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [_NineC]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _nine(ts) -> _NineC:
    out = _NineC()
    for i, x in enumerate(ts):
        out.p[i] = None if x is None else x.data_ptr()
    return out


def _dims(durs, t):
    """(B, M, N) of a launch: one trajectory is B = 1 with M = t.numel();
    a batch's t is (B, M)."""
    N = durs.shape[-1]
    if durs.dim() == 1:
        return 1, t.numel(), N
    B = durs.shape[0]
    if t.dim() != 2 or t.shape[0] != B:
        raise ValueError(f"t {tuple(t.shape)}: a batch of {B} trajectories "
                         "takes times (B, M)")
    return B, t.shape[1], N


def _check(starts, durs, cum, coeffs, t):
    """What the kernel takes: tensors of one dtype (float32 or float64) on
    one card, contiguous, quintic pieces."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"t is {t.dtype}: K5 takes float32 or float64")
    ins = dict(starts=starts, durs=durs, cum=cum, coeffs=coeffs, t=t)
    for name, x in ins.items():
        if not x.is_cuda or x.device != t.device:
            raise ValueError(f"{name} must lie on {t.device}")
        if x.dtype != t.dtype:
            raise TypeError(f"{name} is {x.dtype}, t {t.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = tuple(durs.shape)
    if (starts.shape != lead or cum.shape != lead
            or coeffs.shape != lead + (fused_zoom.N_COEF, 3)):
        raise ValueError(f"starts/durs/cum/coeffs {tuple(starts.shape)} / "
                         f"{lead} / {tuple(cum.shape)} / "
                         f"{tuple(coeffs.shape)}: expected (..., N) and "
                         f"(..., N, {fused_zoom.N_COEF}, 3)")


def _forward(starts, durs, cum, coeffs, t):
    global LAUNCHES
    B, M, N = _dims(durs, t)
    out = tuple(torch.empty_like(t) for _ in range(9))
    if B * M == 0:
        return out
    err = _load().isdf_pieces_forward(
        _DTYPES[t.dtype], starts.data_ptr(), durs.data_ptr(), cum.data_ptr(),
        coeffs.data_ptr(), t.data_ptr(), _nine(out), B, M, N,
        fused_zoom._stream(t.device))
    if err != 0:
        raise RuntimeError(f"K5 forward launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _backward(starts, durs, cum, coeffs, t, grads, want_t: bool):
    global LAUNCHES_BACKWARD
    B, M, N = _dims(durs, t)
    tiles = -(-M // TILE)
    grads = tuple(None if g is None else g.contiguous() for g in grads)
    gt = torch.empty_like(t) if want_t else None
    partial = torch.empty((B, tiles, N, VALUES), dtype=t.dtype,
                          device=t.device)
    g_coeffs = torch.empty_like(coeffs)
    g_starts, g_durs = torch.empty_like(starts), torch.empty_like(durs)
    err = _load().isdf_pieces_backward(
        _DTYPES[t.dtype], starts.data_ptr(), durs.data_ptr(), cum.data_ptr(),
        coeffs.data_ptr(), t.data_ptr(), _nine(grads),
        None if gt is None else gt.data_ptr(), partial.data_ptr(),
        g_coeffs.data_ptr(), g_starts.data_ptr(), g_durs.data_ptr(), B, M, N,
        tiles, fused_zoom._stream(t.device))
    if err != 0:
        raise RuntimeError(f"K5 backward launch failed: CUDA error {err}")
    LAUNCHES_BACKWARD += 1
    return g_starts, g_durs, g_coeffs, gt


class _Pvaj(torch.autograd.Function):
    """(starts, durs, cum, coeffs, t) → the nine components; the gradient
    reaches starts, durs, coeffs and t (cum only locates the pieces)."""

    @staticmethod
    def forward(ctx, starts, durs, cum, coeffs, t):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(starts, durs, cum, coeffs, t)
        return _forward(starts, durs, cum, coeffs, t)

    @staticmethod
    def backward(ctx, *grads):
        starts, durs, cum, coeffs, t = ctx.saved_tensors
        if all(g is None for g in grads):
            return None, None, None, None, None
        g_starts, g_durs, g_coeffs, g_t = _backward(
            starts, durs, cum, coeffs, t, grads, ctx.needs_input_grad[4])
        return g_starts, g_durs, None, g_coeffs, g_t


def pvaj_at(traj, t: torch.Tensor):
    """pos, vel, acc 3-tuples of tensors shaped like t at global times t
    (for a batched traj, t (B, M)), in t's dtype: ``fast_eval.pvaj_tables``
    on ``fast_eval.piece_tables``, through K5 for times on a card (any
    number of pieces: the piece search is a bisection and the backward's
    shared memory does not grow with N)."""
    tables = piece_tables(traj, t.dtype)
    if not t.is_cuda:
        return pvaj_tables(*tables, t, 3)
    ins = tuple(a.contiguous() for a in tables + (t,))
    _check(*ins)
    out = _Pvaj.apply(*ins)
    return out[0:3], out[3:6], out[6:9]


def pvaj_backward_ref(starts, durs, cum, coeffs, t, grads):
    """K5's backward in PyTorch operations, its arithmetic per time in the
    kernel's order → (∂/∂starts, ∂/∂durs, ∂/∂coeffs, ∂/∂t) of Σ gᵢ·outᵢ,
    ``grads`` the nine components' gradients (None: zero).  The clip
    splits the gradient half and half where its operands are equal, as
    torch.maximum/minimum do; the per-piece sum is ``index_add_`` over the
    times in their order."""
    batched = cum.dim() == 2
    total = cum[:, -1:] if batched else cum[-1]
    idx = piece_index(cum, clip(t, 0.0, total).detach())
    dur = take_pieces(durs, idx, batched)
    u = t - take_pieces(starts, idx, batched)
    zero = torch.zeros_like(u)
    m = torch.maximum(u, zero)
    s = torch.minimum(m, dur)
    c = take_pieces(coeffs, idx, batched)                   # (..., 6, 3)
    g = [zero if x is None else x for x in grads]
    s2 = s * s
    s3 = s2 * s
    s4 = s3 * s
    s5 = s4 * s
    rows = [[] for _ in range(6)]
    gs = zero
    for ax in range(3):
        gp, gv, ga = g[ax], g[3 + ax], g[6 + ax]
        rows[0].append(gp)
        rows[1].append(gp * s + gv)
        rows[2].append(gp * s2 + gv * (2.0 * s) + ga * 2.0)
        rows[3].append(gp * s3 + gv * (3.0 * s2) + ga * (6.0 * s))
        rows[4].append(gp * s4 + gv * (4.0 * s3) + ga * (12.0 * s2))
        rows[5].append(gp * s5 + gv * (5.0 * s4) + ga * (20.0 * s3))
        c1, c2, c3, c4, c5 = (c[..., k, ax] for k in range(1, 6))
        vel = (((c5 * 5.0 * s + c4 * 4.0) * s + c3 * 3.0) * s
               + c2 * 2.0) * s + c1
        acc = ((c5 * 20.0 * s + c4 * 12.0) * s + c3 * 6.0) * s + c2 * 2.0
        jerk = (c5 * 60.0 * s + c4 * 24.0) * s + c3 * 6.0
        gs = gs + gp * vel + gv * acc + ga * jerk
    gm = torch.where(m == dur, gs * 0.5, torch.where(m > dur, zero, gs))
    gd = torch.where(m == dur, gs * 0.5, torch.where(m < dur, zero, gs))
    gu = torch.where(u == 0.0, gm * 0.5, torch.where(u < 0.0, zero, gm))
    vals = torch.cat([torch.stack([torch.stack(r, -1) for r in rows], -2)
                      .flatten(-2), -gu[..., None], gd[..., None]], -1)
    N = durs.shape[-1]
    B = durs.shape[0] if batched else 1
    flat = idx.reshape(B, -1) + N * torch.arange(
        B, device=idx.device)[:, None]
    sums = torch.zeros((B * N, VALUES), dtype=vals.dtype,
                       device=vals.device).index_add_(
        0, flat.reshape(-1), vals.reshape(-1, VALUES))
    sums = sums.reshape(durs.shape + (VALUES,))
    return (sums[..., 18], sums[..., 19],
            sums[..., :18].reshape(coeffs.shape), gu)
