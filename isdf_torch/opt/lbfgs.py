"""L-BFGS with the Lewis–Overton weak-Wolfe line search (counterpart of
``isdf_tpu/opt/lbfgs.py:minimize``).

The JAX version is one ``lax.while_loop`` under jit; here the loops are
Python loops over tensors, and the scalar decisions (Armijo, curvature,
convergence) are taken on the host.  An opaque ``aux`` threads through the
cost callback across iterations (the swept-SDF t* warm starts, the
reference's ``lastTstar``).

cost_and_grad signature:  (x, aux) -> (f, g, new_aux), f a 0-d tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class LBFGSResult:
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    n_iters: int
    n_evals: int
    converged: bool
    aux: Any
    history: torch.Tensor   # (max_iters,) cost trace, NaN-padded


def _two_loop(g, S, Y, rho, n_corr: int, head: int, m: int):
    """Two-loop recursion over a ring buffer (most recent = head−1)."""
    q = g
    alphas = [0.0] * m
    for i in range(n_corr):
        slot = (head - 1 - i) % m
        a = rho[slot] * torch.dot(S[slot], q)
        q = q - a * Y[slot]
        alphas[slot] = a
    last = (head - 1) % m
    if n_corr > 0:
        yy = torch.dot(Y[last], Y[last])
        sy = torch.dot(S[last], Y[last])
        gamma = sy / torch.clamp(yy, min=1e-30)
    else:
        gamma = 1.0
    r = gamma * q
    for i in range(n_corr):
        slot = (head - n_corr + i) % m
        b = rho[slot] * torch.dot(Y[slot], r)
        r = r + S[slot] * (alphas[slot] - b)
    return r


def _line_search(cost_and_grad, x, f0, g0, d, aux, max_ls, c1=1e-4, c2=0.9,
                 step0=1.0):
    """Lewis–Overton bisection search for the weak Wolfe conditions, with a
    safeguarded quadratic step on Armijo failure.  aux is frozen during the
    search (every trial evaluates the same f(·, aux)); the accepted trial's
    refreshed aux is carried out.  Returns (step, f, g, aux, ok, evals)."""
    f0v = float(f0)
    dg0 = float(torch.dot(g0, d))
    step, lo, hi = float(step0), 0.0, math.inf
    f, g, aux2 = f0, g0, aux
    ok = False
    evals = 0
    while not ok and evals < max_ls:
        ft, gt, auxt = cost_and_grad(x + step * d, aux)
        evals += 1
        ftv = float(ft)
        armijo = ftv <= f0v + c1 * step * dg0
        curv = float(torch.dot(gt, d)) >= c2 * dg0
        ok = armijo and curv
        if not armijo:
            hi = step
        if armijo and not curv:
            lo = step
        denom = ftv - f0v - dg0 * step
        t_q = -dg0 * step * step / (2.0 * max(denom, 1e-30))
        a_lo, a_hi = lo + 0.1 * (hi - lo), lo + 0.9 * (hi - lo)
        mid = min(max(t_q, a_lo), a_hi)
        if not math.isfinite(mid):
            mid = 0.5 * (lo + hi)
        if not ok:
            step = mid if math.isfinite(hi) else 2.0 * max(step, lo)
        f, g, aux2 = ft, gt, auxt
    improved = float(f) < f0v
    if improved:
        return step, f, g, aux2, True, evals
    return 0.0, f0, g0, aux, ok, evals


def minimize(
    cost_and_grad: Callable,
    x0: torch.Tensor,
    aux0=None,
    m: int = 16,
    max_iters: int = 300,
    g_epsilon: float = 1e-6,
    past: int = 10,
    rel_cost_tol: float = 1e-8,
    max_ls: int = 24,
) -> LBFGSResult:
    """Run L-BFGS from x0.

    Every iteration re-evaluates cost+grad at (x, aux) first, so the
    line-search baseline and the direction agree with the refreshed aux (t*
    warm seeds) — the JAX solver's ``consistent_baseline=True``, its
    default and the only mode the planner uses."""
    n = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    trace = torch.full((max_iters,), math.nan, dtype=dtype, device=dev)
    f, g, aux = cost_and_grad(x0, aux0)
    x = x0
    S = torch.zeros((m, n), dtype=dtype, device=dev)
    Y = torch.zeros((m, n), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    n_corr, head, it, evals = 0, 0, 0, 1
    fpast = [math.inf] * past
    fpast[0] = float(f)
    done = False

    while not done and it < max_iters:
        f0, g0, _ = cost_and_grad(x, aux)
        d = -_two_loop(g0, S, Y, rho, n_corr, head, m)
        if not float(torch.dot(d, g0)) < 0:
            d = -g0
        # without curvature pairs d = −g; scale the first trial step
        # like LBFGS-Lite (ref lbfgs.hpp:565: step = 1/‖d‖ at k = 1)
        step0 = 1.0 if n_corr > 0 else \
            1.0 / max(float(torch.linalg.norm(d)), 1.0)
        step, f, g, aux, ok, ls_evals = _line_search(
            cost_and_grad, x, f0, g0, d, aux, max_ls, step0=step0)
        x_new = x + step * d
        s = x_new - x
        y = g - g0
        sy = float(torch.dot(s, y))
        good = ok and sy > 1e-10 * float(torch.linalg.norm(s)) * float(
            torch.linalg.norm(y))
        if good:
            S[head] = s
            Y[head] = y
            rho[head] = 1.0 / sy
            head = (head + 1) % m
            n_corr = min(n_corr + 1, m)

        gnorm = float(torch.linalg.norm(g)) / max(
            float(torch.linalg.norm(x_new)), 1.0)
        fv = float(f)
        # the slot about to be overwritten was written `past` iterations ago
        f_old = fpast[(it + 1) % past]
        conv_f = it >= past and (f_old - fv) / max(abs(fv), 1.0) < rel_cost_tol
        done = gnorm < g_epsilon or conv_f or not ok
        fpast[(it + 1) % past] = fv
        trace[it % max_iters] = f
        x = x_new
        evals += ls_evals + 1
        it += 1

    return LBFGSResult(x=x, f=f, g=g, n_iters=it, n_evals=evals,
                       converged=done, aux=aux, history=trace)
