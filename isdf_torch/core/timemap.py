"""The τ ↔ T diffeomorphism for unconstrained time optimization
(counterpart of ``isdf_tpu/core/timemap.py``).

  T(τ) = 0.5 τ² + τ + 1            (τ > 0)
  T(τ) = 1 / (0.5 τ² − τ + 1)      (τ ≤ 0)
"""

from __future__ import annotations

import torch


def tau_to_T(tau: torch.Tensor) -> torch.Tensor:
    pos = (0.5 * tau + 1.0) * tau + 1.0
    neg = 1.0 / ((0.5 * tau - 1.0) * tau + 1.0)
    return torch.where(tau > 0.0, pos, neg)


def T_to_tau(T: torch.Tensor) -> torch.Tensor:
    upper = torch.sqrt(torch.clamp(2.0 * T - 1.0, min=0.0)) - 1.0
    lower = 1.0 - torch.sqrt(
        torch.clamp(2.0 / torch.clamp(T, min=1e-12) - 1.0, min=0.0))
    return torch.where(T > 1.0, upper, lower)
