"""Limited-Memory Bundle Method (counterpart of ``isdf_tpu/opt/lmbm.py``).

The reference's back end drives a Fortran77 LMBM (Haarala–Miettinen–Mäkelä;
ref lmbm_main.f + lmbm_sub.f through lmbm/lmbm.cpp, called from
back_end_optimizer.cpp:99) because the swept-SDF safety cost is only
piecewise smooth: the argmin time t* jumps between local minima.  Like the
JAX package's, this is a re-derivation of the method's core, not a port of
the Fortran:

  * subgradient locality measures β⁺ = max(|f(x) − f(y) + g⁺ᵀ(y − x)|,
    γ‖y − x‖²) for a trial y = x + t d (the Fortran's ALFN, GAM);
  * three-point aggregation: (ĝ, β̂) minimises ‖λ₁g_m + λ₂g⁺ + λ₃ĝ‖² +
    2(λ₂β⁺ + λ₃β̂) over the unit simplex (AGBFGS), solved exactly;
  * serious/null steps: f(x + t d) ≤ f − ε_L t w with w = −ĝᵀd + 2β̂;
  * the dual limited-memory model: BFGS two-loop after a serious step, the
    compact inverse SR1 with γ = 1 after a null step (DLBFGS/DLSR1), null
    pairs folded into the shared memory under s·y > 1e-12, and a restart
    (memory and aggregate cleared) after a stalled null streak.

The JAX version is one ``lax.while_loop``; here the loop runs on the host
over tensors, as the port's ``lbfgs.minimize`` does, and its tests (serious,
good pair, restart, done) are host booleans: a few synchronisations an
iteration on the card.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from isdf_torch.opt.lbfgs import LBFGSResult, _two_loop


def _solve(A, b):
    """A⁻¹b, NaN where A is singular: what an LU solve gives the JAX
    version, whose callers then drop the candidate (a NaN fails every
    test), where ``torch.linalg.solve`` would raise."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


def _aggregate3(g_m, g_new, g_hat, beta_new, beta_hat):
    """Solve min_{λ∈Δ²} ‖λ₁g_m + λ₂g⁺ + λ₃ĝ‖² + 2(λ₂β⁺ + λ₃β̂) exactly over
    the 2-simplex: the 3 vertices, the 3 edges' clipped stationary points
    and the regularised interior point (when feasible); the first candidate
    of least value wins.  → (aggregate subgradient, aggregate locality)."""
    G = torch.stack([g_m, g_new, g_hat])                  # (3, n)
    b = torch.stack([torch.zeros_like(beta_new), beta_new, beta_hat])
    Q = G @ G.T
    dtype, dev = Q.dtype, Q.device

    def phi(lam):
        return lam @ Q @ lam + 2.0 * torch.dot(lam, b)

    eps = 1e-12
    cands = [torch.eye(3, dtype=dtype, device=dev)[i] for i in range(3)]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        a2 = Q[i, i] - 2 * Q[i, j] + Q[j, j]
        a1 = Q[i, j] - Q[j, j] + b[i] - b[j]
        mu = torch.clamp(-a1 / torch.clamp(a2, min=eps), 0.0, 1.0)
        lam = torch.zeros(3, dtype=dtype, device=dev)
        lam[i] = mu
        lam[j] = 1.0 - mu
        cands.append(lam)
    # interior: [2Q 1; 1ᵀ 0][λ; ν] = [−2b; 1], through the regularised 3×3
    A = 2.0 * Q + eps * torch.eye(3, dtype=dtype, device=dev)
    ones = torch.ones(3, dtype=dtype, device=dev)
    Ainv_b = _solve(A, -2.0 * b)
    Ainv_1 = _solve(A, ones)
    nu = (1.0 - torch.dot(ones, Ainv_b)) / torch.clamp(
        torch.dot(ones, Ainv_1), min=eps)
    lam_int = Ainv_b + nu * Ainv_1
    feasible = bool((lam_int >= 0.0).all())
    vals = [phi(c) for c in cands]
    if feasible:
        cands.append(lam_int)
        vals.append(phi(lam_int))
    else:
        cands.append(cands[0])
        vals.append(torch.full_like(vals[0], math.inf))
    lam = cands[int(torch.argmin(torch.stack(vals)))]
    return lam @ G, torch.dot(lam, b)


def _sr1_direction(g, S, Y, rho, n_corr: int, head: int, m: int):
    """−H·g with the compact limited-memory inverse SR1 over the ring
    buffer's valid pairs, γ = 1 (the Fortran's DLSR1); invalid slots are
    masked to identity rows so the solve stays regular.  ``rho`` is unused,
    as in the JAX version."""
    dtype, dev = g.dtype, g.device
    ar = torch.arange(m, device=dev)
    order = (head - n_corr + ar) % m
    valid = (ar < n_corr).to(dtype)
    Sv = S[order] * valid[:, None]
    Yv = Y[order] * valid[:, None]
    gam = 1.0
    W = Yv @ Sv.T                                         # YᵀS
    D = torch.diag(torch.diag(W))
    L = torch.tril(W, diagonal=-1)
    M = D + L + L.T - gam * (Yv @ Yv.T)
    M = M * (valid[:, None] * valid[None, :]) + torch.diag(1.0 - valid)
    A = Sv - gam * Yv
    coef = _solve(M + 1e-12 * torch.eye(m, dtype=dtype, device=dev),
                  A @ g) * valid
    return -(gam * g + A.T @ coef)


def minimize(
    cost_and_grad: Callable,
    x0: torch.Tensor,
    aux0=None,
    m: int = 8,
    max_iters: int = 400,
    tol: float = 1e-6,
    eps_l: float = 1e-4,
    gamma: float = 0.25,
    max_ls: int = 12,
    max_null: int = 50,
    max_restarts: int = 2,
    sr1_null_steps: bool = True,
) -> LBFGSResult:
    """Minimize a (possibly nonsmooth) function; the signature and result
    of ``lbfgs.minimize`` (``g`` is the aggregate subgradient, ``n_evals`` 1
    + the line-search trials, ``stats`` the serious and null steps and the
    restarts).

    gamma: the locality measure's distance parameter (the Fortran's GAM;
    keep γ > 0 on nonconvex landscapes).  eps_l: the serious-step
    sufficient-decrease fraction (EPSL)."""
    n = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    x = x0
    f, g, aux = cost_and_grad(x0, aux0)
    g_hat = g
    beta_hat = torch.zeros((), dtype=dtype, device=dev)
    S = torch.zeros((m, n), dtype=dtype, device=dev)
    Y = torch.zeros((m, n), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    n_corr = head = it = null_streak = n_restarts = 0
    evals = 1
    stats = dict(serious=0, null=0, restarts=0)
    done = False
    trace = torch.full((max_iters,), math.nan, dtype=dtype, device=dev)

    while not done and it < max_iters:
        if sr1_null_steps and null_streak > 0:
            # the dual model: SR1 on the aggregate after a null step
            d = _sr1_direction(g_hat, S, Y, rho, n_corr, head, m)
        else:
            # the SCLPAR-style clamp keeps a degenerate pair at a kink from
            # collapsing the direction
            d = -_two_loop(g_hat, S, Y, rho, n_corr, head, m,
                           gamma_clamp=(0.01, 100.0))
        if not float(torch.dot(d, g_hat)) < 0:
            d = -g_hat
        # the desirable descent w = −ĝᵀd + 2β̂ (the Fortran's WK)
        w = torch.clamp(-torch.dot(d, g_hat) + 2.0 * beta_hat, min=1e-30)

        # backtracking over t ∈ {1, 1/2, ...} for the serious-step decrease;
        # the next trial step t and the step t_eval at which (f_t, g_t) were
        # evaluated are kept apart: a failed last trial halves t, and the
        # null step's locality measure uses t_eval (ALFN, lmbm_sub.f:2460).
        # The trials thread their refreshed aux from one to the next.
        t, t_eval = 1.0, 1.0
        f_t, g_t, aux_t = f, g_hat, aux
        k_ls, serious = 0, False
        while not serious and k_ls < max_ls:
            ft, gt, auxt = cost_and_grad(x + t * d, aux_t)
            ok = bool(ft <= f - eps_l * t * w)
            t_eval, t = t, (t if ok else 0.5 * t)
            f_t, g_t, aux_t = ft, gt, auxt
            k_ls += 1
            serious = ok
        x_t = x + t_eval * d

        # the correction pair of the serious or null step, into the shared
        # memory under positive curvature
        s_vec = x_t - x
        y_vec = g_t - g
        sy = torch.dot(s_vec, y_vec)
        if bool(sy > 1e-12):
            S[head] = s_vec
            Y[head] = y_vec
            rho[head] = 1.0 / torch.clamp(sy, min=1e-30)
            head = (head + 1) % m
            n_corr = min(n_corr + 1, m)

        # the null step's locality measure of the trial subgradient at x
        alf = f - f_t + t_eval * torch.dot(g_t, d)
        beta_new = torch.maximum(
            torch.abs(alf), gamma * ((t_eval * t_eval) * torch.dot(d, d)))
        if serious:
            x, f, g, g_hat = x_t, f_t, g_t, g_t
            beta_hat = torch.zeros_like(beta_hat)
            aux = aux_t
            null_streak = 0
        else:
            g_hat, beta_hat = _aggregate3(g, g_t, g_hat, beta_new, beta_hat)
            null_streak += 1

        wk = torch.dot(g_hat, g_hat) + 2.0 * beta_hat
        # a stalled null streak restarts (memory and aggregate cleared);
        # the solve gives up after max_restarts restarts in a row
        restart = null_streak > max_null
        exhausted = restart and n_restarts >= max_restarts
        if restart:
            n_corr = head = null_streak = 0
            g_hat = g
            beta_hat = torch.zeros_like(beta_hat)
        done = bool(wk < tol * tol) or exhausted
        n_restarts = 0 if serious else n_restarts + int(restart)
        stats["serious" if serious else "null"] += 1
        stats["restarts"] += int(restart)
        trace[it] = f
        evals += k_ls
        it += 1

    return LBFGSResult(x=x, f=f, g=g_hat, n_iters=it, n_evals=evals,
                       converged=done, aux=aux, history=trace, stats=stats)
