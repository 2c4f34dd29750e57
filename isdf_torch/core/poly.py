"""Piecewise-polynomial trajectories (counterpart of ``isdf_tpu/core/poly.py``).

A trajectory is (durations[N], coeffs[N, n_coef, 3]) with ascending power
coefficients per piece — pos(s) = Σ_k coeffs[i, k] s^k for local time s in
piece i.  Evaluation at a global time uses a discrete piece lookup; gradients
flow through the local time s = t − Σ_{j<i} T_j (autograd).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def deriv_tables(n_coef: int):
    """[0][d, k] = k!/(k−d)! (0 for k < d), [1][d, k] = max(k−d, 0)."""
    fact = np.zeros((n_coef + 1, n_coef))
    powr = np.zeros((n_coef + 1, n_coef), dtype=np.int64)
    for d in range(n_coef + 1):
        for k in range(n_coef):
            if k >= d:
                fact[d, k] = math.factorial(k) / math.factorial(k - d)
                powr[d, k] = k - d
    return fact, powr


def beta(s: torch.Tensor, order: int, n_coef: int = 6) -> torch.Tensor:
    """Basis β_order(s) with β·c = d^order pos / ds^order, shape (..., n_coef).

    Powers come from iterated products, not ``pow``, so the derivative of s⁰
    stays finite at s = 0.  The columns are stacked from the powers, not
    gathered by index: an index's backward on the card is a sort-based
    scatter."""
    order = min(order, n_coef)
    pows = [torch.ones_like(s)]
    for _ in range(n_coef - 1):
        pows.append(pows[-1] * s)
    P = torch.stack([pows[k] for k in deriv_tables(n_coef)[1][order]], -1)
    return _beta_fact(order, n_coef, s.dtype, s.device) * P


@functools.lru_cache(maxsize=None)
def _beta_fact(order: int, n_coef: int, dtype, device):
    """Row ``order`` of deriv_tables' factors on the device, copied there
    once (a copy at each call would make the host wait for the device)."""
    return torch.as_tensor(deriv_tables(n_coef)[0][order], dtype=dtype,
                           device=device)


def take_pieces(x: torch.Tensor, idx: torch.Tensor, batched: bool):
    """Rows of the per-piece table x at piece indices idx: x[idx] for one
    trajectory (x (N, ...)), and for a batch (x (B, N, ...), idx (B, M))
    each scenario's own rows, (B, M, ...)."""
    if not batched:
        return x[idx]
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


@dataclass
class PolyTraj:
    """(durations[N], coeffs[N, n_coef, 3]) — ascending powers.

    With a leading scenario axis — durations (B, N), coeffs (B, N, n_coef, 3)
    — it is a batch of B independent trajectories with N pieces each; global
    times are then (B, M), one row per scenario."""

    durations: torch.Tensor
    coeffs: torch.Tensor

    @property
    def batched(self) -> bool:
        return self.durations.dim() == 2

    @property
    def n_pieces(self) -> int:
        return self.durations.shape[-1]

    @property
    def n_coef(self) -> int:
        return self.coeffs.shape[-2]

    @property
    def total_duration(self) -> torch.Tensor:
        return torch.sum(self.durations, dim=-1)

    def locate(self, t):
        """(piece index, local time) for global times t.  The index is
        discrete; the local time is differentiable in t and the durations."""
        cum = torch.cumsum(self.durations, -1)
        starts = cum - self.durations
        t = torch.as_tensor(t, dtype=self.durations.dtype,
                            device=self.durations.device)
        total = cum[..., -1:] if self.batched else cum[-1]
        tc = torch.minimum(torch.maximum(t, torch.zeros_like(total)),
                           total).detach()
        # one row of boundaries per trajectory: () for one, (B,) for a batch
        rows = tc.reshape(cum.shape[:-1] + (-1,)).contiguous()
        idx = torch.searchsorted(cum.detach().contiguous(), rows,
                                 right=False).reshape(tc.shape)
        idx = idx.clamp(0, self.n_pieces - 1)
        return idx, t - take_pieces(starts, idx, self.batched)

    def eval_local(self, idx, s, order: int = 0):
        c = take_pieces(self.coeffs, idx, self.batched)  # (..., n_coef, 3)
        b = beta(s, order, self.n_coef)                 # (..., n_coef)
        return torch.einsum("...k,...kd->...d", b, c)

    def eval(self, t, order: int = 0):
        idx, s = self.locate(t)
        return self.eval_local(idx, s, order)

    def pos(self, t):
        return self.eval(t, 0)

    def pvaj(self, t):
        """pos/vel/acc/jerk at global times t, each (..., 3)."""
        idx, s = self.locate(t)
        c = take_pieces(self.coeffs, idx, self.batched)
        return tuple(
            torch.einsum("...k,...kd->...d", beta(s, d, self.n_coef), c)
            for d in range(4)
        )

    def junction_positions(self):
        """Positions at piece boundaries (N+1 points; (B, N+1, 3) for a
        batch)."""
        start = self.coeffs[..., 0, :]
        b = beta(self.durations[..., -1], 0, self.n_coef)
        last = torch.einsum("...k,...kd->...d", b, self.coeffs[..., -1, :, :])
        return torch.cat([start, last[..., None, :]], dim=-2)

    def detach(self) -> "PolyTraj":
        return PolyTraj(self.durations.detach(), self.coeffs.detach())
