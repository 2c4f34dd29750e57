"""Smoothed penalty hinges (counterpart of ``isdf_tpu/core/smoothing.py``).

``clip``, ``vmax`` and ``vmin`` keep JAX's gradient convention at ties
(``jnp.clip``/``jnp.maximum`` split the gradient 0.5/0.5 at equality, while
``torch.clamp`` gives all of it to the input): the port's gradients then
agree with the reference's also where a value sits exactly on a bound, as the
zoom's clipped candidates and the piece-local times often do.
"""

from __future__ import annotations

import torch


def _like(x: torch.Tensor, v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def vmax(a: torch.Tensor, b) -> torch.Tensor:
    return torch.maximum(a, _like(a, b))


def vmin(a: torch.Tensor, b) -> torch.Tensor:
    return torch.minimum(a, _like(a, b))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with its gradient: min(max(x, lo), hi)."""
    return vmin(vmax(x, lo), hi)


def vabs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient at 0 (+1, where torch gives 0)."""
    return torch.where(x < 0.0, -x, x)


def sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x ≥ 0, with slope 0 at x = 0 where torch.sqrt's is
    infinite (times a zero upstream gradient, NaN); the same values."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def smoothed_l1(x: torch.Tensor, mu: float) -> torch.Tensor:
    """C¹ hinge: 0 for x≤0, cubic blend on (0, μ), linear x − μ/2 beyond."""
    xc = clip(x, 0.0, mu)
    xdmu = xc / mu
    blend = (mu - 0.5 * xc) * xdmu * xdmu * xdmu
    zero = torch.zeros_like(x)
    return torch.where(x <= 0.0, zero,
                       torch.where(x >= mu, x - 0.5 * mu, blend))


def cubic_hinge(x: torch.Tensor) -> torch.Tensor:
    """x³ for x>0 else 0 (ref cubic(), mid-end waypoint attraction)."""
    xp = vmax(x, 0.0)
    return xp * xp * xp
