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
    stays finite at s = 0."""
    fact, powr = deriv_tables(n_coef)
    order = min(order, n_coef)
    pows = [torch.ones_like(s)]
    for _ in range(n_coef - 1):
        pows.append(pows[-1] * s)
    P = torch.stack(pows, dim=-1)
    f = torch.as_tensor(fact[order], dtype=s.dtype, device=s.device)
    idx = torch.as_tensor(powr[order], device=s.device)
    return f * P[..., idx]


@dataclass
class PolyTraj:
    """(durations[N], coeffs[N, n_coef, 3]) — ascending powers."""

    durations: torch.Tensor
    coeffs: torch.Tensor

    @property
    def n_pieces(self) -> int:
        return self.durations.shape[0]

    @property
    def n_coef(self) -> int:
        return self.coeffs.shape[1]

    @property
    def total_duration(self) -> torch.Tensor:
        return torch.sum(self.durations)

    def locate(self, t):
        """(piece index, local time) for global times t.  The index is
        discrete; the local time is differentiable in t and the durations."""
        cum = torch.cumsum(self.durations, 0)
        starts = cum - self.durations
        t = torch.as_tensor(t, dtype=self.durations.dtype,
                            device=self.durations.device)
        tc = torch.minimum(torch.maximum(t, torch.zeros_like(cum[-1])),
                           cum[-1]).detach()
        idx = torch.searchsorted(cum.detach(), tc.reshape(-1), right=False)
        idx = idx.clamp(0, self.n_pieces - 1).reshape(tc.shape)
        return idx, t - starts[idx]

    def eval_local(self, idx, s, order: int = 0):
        c = self.coeffs[idx]                            # (..., n_coef, 3)
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
        c = self.coeffs[idx]
        return tuple(
            torch.einsum("...k,...kd->...d", beta(s, d, self.n_coef), c)
            for d in range(4)
        )

    def junction_positions(self):
        """Positions at piece boundaries (N+1 points)."""
        start = self.coeffs[:, 0, :]
        last = self.eval_local(self.n_pieces - 1, self.durations[-1], 0)
        return torch.cat([start, last[None]], dim=0)

    def detach(self) -> "PolyTraj":
        return PolyTraj(self.durations.detach(), self.coeffs.detach())
