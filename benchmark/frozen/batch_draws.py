"""The scenario draws of ``isdf_torch.parallel.batch.make_random_batch`` (the
JAX package's, in its order), in numpy: random goals and obstacle clusters
along the straight line from rest at the origin."""

from __future__ import annotations

import numpy as np


def draw_batch(inittime: float, B: int, N: int, n_points: int, seed: int):
    """-> dict of numpy arrays head (B,3,3), tail (B,3,3), q0 (B,N-1,3),
    T0 (B,N), points (B,P,3), mask (B,P)."""
    rng = np.random.default_rng(seed)
    goals = rng.uniform(4.0, 8.0, size=(B, 3)) * np.array([1.0, 0.5, 0.3])
    head = np.zeros((B, 3, 3))
    tail = np.zeros((B, 3, 3))
    tail[:, :, 0] = goals
    fracs = np.linspace(0, 1, N + 1)[1:-1]
    q0 = goals[:, None, :] * fracs[None, :, None]
    q0 = q0 + rng.normal(scale=0.2, size=q0.shape)
    T0 = np.full((B, N), inittime)
    t = rng.uniform(0.1, 0.9, size=(B, n_points, 1))
    points = goals[:, None, :] * t + rng.normal(scale=0.8,
                                                size=(B, n_points, 3))
    mask = np.ones((B, n_points), dtype=bool)
    return dict(head=head, tail=tail, q0=q0, T0=T0, points=points, mask=mask)
