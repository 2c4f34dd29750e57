"""L-BFGS with the Lewis–Overton weak-Wolfe line search (counterpart of
``isdf_tpu/opt/lbfgs.py``: ``minimize``, ``minimize_chunked`` and
``minimize_lockstep``).

The JAX version is one ``lax.while_loop`` under jit; here the loops are
Python loops over tensors, and the scalar decisions (Armijo, curvature,
convergence) are taken on the host.  An opaque ``aux`` threads through the
cost callback across iterations (the swept-SDF t* warm starts, the
reference's ``lastTstar``).

cost_and_grad signature:  (x, aux) -> (f, g, new_aux), f a 0-d tensor.

``minimize_lockstep`` is the scenario-batched solver: x is (B, n), f is (B,),
and every scenario's search advances by one trial per loop trip, all on the
device with no decision taken on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

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
    history: torch.Tensor   # (trace_len,) cost trace, NaN-padded
    state: Any = None       # the solver state to resume from (minimize)
    stats: Any = None       # lmbm: serious and null steps, restarts


@dataclass
class LBFGSState:
    """Solver state of :func:`minimize` between iterations, enough to resume
    a solve (chunked execution)."""

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    aux: Any
    S: torch.Tensor          # (m, n) s history
    Y: torch.Tensor          # (m, n) y history
    rho: torch.Tensor        # (m,)
    n_corr: int              # valid corrections
    head: int                # ring-buffer head
    it: int
    evals: int
    done: bool
    fpast: list              # (past,) rolling costs


def _two_loop(g, S, Y, rho, n_corr: int, head: int, m: int,
              gamma_clamp=None):
    """Two-loop recursion over a ring buffer (most recent = head−1).

    gamma_clamp: optional (lo, hi) safeguard for the initial-Hessian scaling
    γ = s·y/y·y (the Fortran LMBM's SCLPAR clamp: a degenerate last pair,
    tiny s·y at a kink, must not collapse the direction); None keeps the
    classic unclamped scaling."""
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
        if gamma_clamp is not None:
            gamma = torch.clamp(gamma, *gamma_clamp)
    else:
        gamma = 1.0 if gamma_clamp is None else \
            min(max(1.0, gamma_clamp[0]), gamma_clamp[1])
    r = gamma * q
    for i in range(n_corr):
        slot = (head - n_corr + i) % m
        b = rho[slot] * torch.dot(Y[slot], r)
        r = r + S[slot] * (alphas[slot] - b)
    return r


def _line_search(cost_and_grad, x, f0, g0, d, aux, max_ls, c1=1e-4, c2=0.9,
                 step0=1.0, armijo_slack=0.0):
    """Lewis–Overton bisection search for the weak Wolfe conditions, with a
    safeguarded quadratic step on Armijo failure.  aux is frozen during the
    search (every trial evaluates the same f(·, aux)); the accepted trial's
    refreshed aux is carried out.  armijo_slack is an absolute slack on the
    sufficient decrease (the baseline-skip mode's allowance for the aux
    drift).  Returns (step, f, g, aux, ok, evals)."""
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
        armijo = ftv <= f0v + c1 * step * dg0 + armijo_slack
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
    resume_state: Optional[LBFGSState] = None,
    trace_len: Optional[int] = None,
    consistent_baseline: bool = True,
) -> LBFGSResult:
    """Run L-BFGS from x0, or ``max_iters`` more iterations from a previous
    result's ``state`` (``resume_state``: the basis of
    :func:`minimize_chunked`; a converged state stays converged).
    ``trace_len`` sizes the cost trace (default max_iters).

    consistent_baseline (default True): every iteration re-evaluates
    cost+grad at (x, aux) first, so the line-search baseline and the
    direction agree with the refreshed aux (t* warm seeds).  False reuses the
    accepted trial's (f, g), computed under the pre-refresh aux, and absorbs
    the drift with a relative Armijo slack: one cost evaluation fewer an
    iteration, at some loss of quality on marginal scenarios."""
    if trace_len is None:
        trace_len = max_iters
    if resume_state is not None:
        st = replace(resume_state, S=resume_state.S.clone(),
                     Y=resume_state.Y.clone(), rho=resume_state.rho.clone(),
                     fpast=list(resume_state.fpast))
        x0 = st.x
    dtype, dev = x0.dtype, x0.device
    trace = torch.full((trace_len,), math.nan, dtype=dtype, device=dev)
    if resume_state is None:
        n = x0.shape[0]
        f, g, aux = cost_and_grad(x0, aux0)
        fpast = [math.inf] * past
        fpast[0] = float(f)
        st = LBFGSState(
            x=x0, f=f, g=g, aux=aux,
            S=torch.zeros((m, n), dtype=dtype, device=dev),
            Y=torch.zeros((m, n), dtype=dtype, device=dev),
            rho=torch.zeros((m,), dtype=dtype, device=dev),
            n_corr=0, head=0, it=0, evals=1, done=False, fpast=fpast)
    it_end = st.it + max_iters

    while not st.done and st.it < it_end:
        if consistent_baseline:
            f0, g0, _ = cost_and_grad(st.x, st.aux)
            slack = 0.0
        else:
            f0, g0 = st.f, st.g
            # purely relative: vanishes as f → 0
            slack = 1e-6 * abs(float(st.f))
        d = -_two_loop(g0, st.S, st.Y, st.rho, st.n_corr, st.head, m)
        if not float(torch.dot(d, g0)) < 0:
            d = -g0
        # without curvature pairs d = −g; scale the first trial step
        # like LBFGS-Lite (ref lbfgs.hpp:565: step = 1/‖d‖ at k = 1)
        step0 = 1.0 if st.n_corr > 0 else \
            1.0 / max(float(torch.linalg.norm(d)), 1.0)
        step, f, g, aux, ok, ls_evals = _line_search(
            cost_and_grad, st.x, f0, g0, d, st.aux, max_ls, step0=step0,
            armijo_slack=slack)
        x_new = st.x + step * d
        s = x_new - st.x
        y = g - g0
        sy = float(torch.dot(s, y))
        good = ok and sy > 1e-10 * float(torch.linalg.norm(s)) * float(
            torch.linalg.norm(y))
        if good:
            st.S[st.head] = s
            st.Y[st.head] = y
            st.rho[st.head] = 1.0 / sy
            st.head = (st.head + 1) % m
            st.n_corr = min(st.n_corr + 1, m)

        gnorm = float(torch.linalg.norm(g)) / max(
            float(torch.linalg.norm(x_new)), 1.0)
        fv = float(f)
        # the slot about to be overwritten was written `past` iterations ago
        f_old = st.fpast[(st.it + 1) % past]
        conv_f = st.it >= past and \
            (f_old - fv) / max(abs(fv), 1.0) < rel_cost_tol
        st.done = gnorm < g_epsilon or conv_f or not ok
        st.fpast[(st.it + 1) % past] = fv
        trace[st.it % trace_len] = f
        st.x, st.f, st.g, st.aux = x_new, f, g, aux
        st.evals += ls_evals + (1 if consistent_baseline else 0)
        st.it += 1

    return LBFGSResult(x=st.x, f=st.f, g=st.g, n_iters=st.it,
                       n_evals=st.evals, converged=st.done, aux=st.aux,
                       history=trace, state=st)


def minimize_chunked(cost_and_grad, x0, aux0=None, m: int = 16,
                     max_iters: int = 300, chunk: int = 8, callback=None,
                     **kw) -> LBFGSResult:
    """L-BFGS in chunks of ``chunk`` iterations, the solver state carried
    across them, with ``callback(result)`` between chunks (the reference's
    per-iteration earlyExit/debug affordance, back_end_optimizer.hpp:
    888-927); a callback that returns False stops the solve.  The iterates
    equal :func:`minimize`'s."""
    res = None
    state = None
    done_iters = 0
    while done_iters < max_iters:
        n = min(chunk, max_iters - done_iters)
        res = minimize(cost_and_grad, x0, aux0, m=m, max_iters=n,
                       resume_state=state, trace_len=chunk, **kw)
        state = res.state
        done_iters = res.n_iters
        if callback is not None and callback(res) is False:
            break
        if res.converged or done_iters == 0:
            break
    return res


# ---------------------------------------------------------------------------
# scenario-batched lockstep solver
# ---------------------------------------------------------------------------

@dataclass
class LockState:
    """Solver state of :func:`minimize_lockstep`; every field has a leading
    scenario axis B."""

    x: torch.Tensor          # (B, n)
    f: torch.Tensor          # (B,) baseline f at x (under aux)
    g: torch.Tensor          # (B, n) baseline gradient at x
    aux: Any                 # (B, ...) or None
    d: torch.Tensor          # (B, n) current search direction
    step: torch.Tensor       # (B,) next trial step
    ls_k: torch.Tensor       # (B,) trials taken in the current search
    S: torch.Tensor          # (B, m, n)
    Y: torch.Tensor          # (B, m, n)
    rho: torch.Tensor        # (B, m)
    n_corr: torch.Tensor     # (B,)
    head: torch.Tensor       # (B,)
    it: torch.Tensor         # (B,) loop trips this scenario was live in
    n_accept: torch.Tensor   # (B,) accepted (serious) steps
    evals: torch.Tensor      # (B,)
    done: torch.Tensor       # (B,) bool
    fpast: torch.Tensor      # (B, past)
    trace: torch.Tensor      # (B, trace_len)


@dataclass
class LockstepResult:
    x: torch.Tensor          # (B, n)
    f: torch.Tensor          # (B,)
    g: torch.Tensor          # (B, n)
    n_iters: torch.Tensor    # (B,) accepted steps
    n_evals: torch.Tensor    # (B,)
    converged: torch.Tensor  # (B,) bool
    aux: Any
    history: torch.Tensor    # (B, trace_len) cost trace, NaN-padded
    state: LockState
    n_loops: int             # loop trips run (2 cost evaluations each)


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) mask shaped to broadcast against ``like`` (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _select(mask, a, b):
    """Per-scenario where(mask, a, b); None passes through."""
    if a is None or b is None:
        return b if a is None else a
    return torch.where(_rows(mask, a), a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _two_loop_lockstep(g, S, Y, rho, n_corr, head, m: int):
    """Two-loop recursion, one ring buffer per scenario.  head and n_corr
    differ between scenarios, so both loops run all m slots under masks, as
    the JAX version does."""
    b = torch.arange(g.shape[0], device=g.device)
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(m):
        slot = (head - 1 - i) % m
        a = rho[b, slot] * _dot(S[b, slot], q)
        a = torch.where(i < n_corr, a, torch.zeros_like(a))
        q = q - a[:, None] * Y[b, slot]
        alphas = alphas.index_put((b, slot), a)
    last = (head - 1) % m
    yy = _dot(Y[b, last], Y[b, last])
    sy = _dot(S[b, last], Y[b, last])
    gamma = torch.where(n_corr > 0, sy / torch.clamp(yy, min=1e-30),
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        slot = (head - n_corr + i) % m
        bb = rho[b, slot] * _dot(Y[b, slot], r)
        upd = S[b, slot] * (alphas[b, slot] - bb)[:, None]
        r = r + torch.where((i < n_corr)[:, None], upd, torch.zeros_like(upd))
    return r


@torch.no_grad()
def minimize_lockstep(
    cost_and_grad: Callable,
    x0: torch.Tensor,
    aux0=None,
    m: int = 16,
    max_iters: int = 300,
    g_epsilon: float = 1e-6,
    past: int = 10,
    rel_cost_tol: float = 1e-8,
    max_ls: int = 24,
    max_loop: Optional[int] = None,
    resume_state: Optional[LockState] = None,
    trace_len: Optional[int] = None,
    c1: float = 1e-4,
    c2: float = 0.9,
) -> LockstepResult:
    """L-BFGS over B independent scenarios with the line search spread across
    loop trips (counterpart of ``isdf_tpu/opt/lbfgs.py:minimize_lockstep``
    under ``jax.vmap``).  x0 (B, n); cost_and_grad(x (B, n), aux) →
    (f (B,), g (B, n), new_aux).

    Every loop trip costs exactly two cost evaluations for the whole batch:

      slot 1: baseline refresh at (x, aux) — consumed by scenarios that start
              a fresh search; a scenario in mid-search keeps its stored
              baseline, so every trial of one search tests the same objective;
      slot 2: one weak-Wolfe trial at x + step·d; accept ⇒ push the pair, new
              direction on the next trip; reject ⇒ halve the step (Armijo
              failed) or double it (only the curvature failed) and retry on
              the next trip.

    max_iters counts accepted steps per scenario.  A scenario that is done,
    has its max_iters accepts, or has been live for max_loop trips is frozen:
    its whole state, evals included, stays as it is while the others run (a
    masked no-op, as under JAX's vmapped ``while_loop``).  The loop runs
    max_loop trips (default 2·max_iters + 8) and never reads a device value
    on the host; the caller reads ``converged`` once afterwards.
    ``resume_state`` continues a solve with max_iters more accepts and
    max_loop more trips (chunked execution); ``trace_len`` sizes the cost
    trace."""
    B, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    if max_loop is None:
        max_loop = 2 * max_iters + 8
    if trace_len is None:
        trace_len = max_loop
    trace = torch.full((B, trace_len), math.nan, dtype=dtype, device=dev)

    if resume_state is not None:
        st = replace(resume_state, trace=trace)
        accept_end = st.n_accept + max_iters
        loop_end = st.it + max_loop
    else:
        f0, g0, aux1 = cost_and_grad(x0, aux0)
        fpast = torch.full((B, past), math.inf, dtype=dtype, device=dev)
        fpast[:, 0] = f0
        d0 = -g0
        zi = torch.zeros(B, dtype=torch.long, device=dev)
        st = LockState(
            x=x0, f=f0, g=g0, aux=aux1, d=d0,
            step=1.0 / torch.clamp(torch.linalg.norm(d0, dim=-1), min=1.0),
            ls_k=zi,
            S=torch.zeros((B, m, n), dtype=dtype, device=dev),
            Y=torch.zeros((B, m, n), dtype=dtype, device=dev),
            rho=torch.zeros((B, m), dtype=dtype, device=dev),
            n_corr=zi, head=zi, it=zi, n_accept=zi, evals=zi + 1,
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            fpast=fpast, trace=trace,
        )
        accept_end = torch.full_like(zi, max_iters)
        loop_end = torch.full_like(zi, max_loop)

    b = torch.arange(B, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for _ in range(max_loop):
        live = (~st.done) & (st.it < loop_end) & (st.n_accept < accept_end)

        # slot 1: baseline refresh
        f_re, g_re, _ = cost_and_grad(st.x, st.aux)
        fresh = st.ls_k == 0
        f0 = torch.where(fresh, f_re, st.f)
        g0 = torch.where(fresh[:, None], g_re, st.g)

        # direction: recomputed on fresh searches only
        d_new = -_two_loop_lockstep(g0, st.S, st.Y, st.rho, st.n_corr,
                                    st.head, m)
        d_new = torch.where((_dot(d_new, g0) < 0)[:, None], d_new, -g0)
        dnorm = torch.linalg.norm(d_new, dim=-1)
        step_new = torch.where(st.n_corr > 0, one,
                               1.0 / torch.clamp(dnorm, min=1.0))
        d = torch.where(fresh[:, None], d_new, st.d)
        step = torch.where(fresh, step_new, st.step)
        dg0 = _dot(d, g0)

        # slot 2: one weak-Wolfe trial
        xt = st.x + step[:, None] * d
        ft, gt, auxt = cost_and_grad(xt, st.aux)
        armijo = ft <= f0 + c1 * step * dg0
        curv = _dot(gt, d) >= c2 * dg0
        ok = armijo & curv
        exhausted = (st.ls_k + 1 >= max_ls) & (~ok)
        # on exhaustion keep the last trial anyway when it decreased f;
        # else the search failed → done
        salvage = exhausted & (ft < f0)
        accept = ok | salvage
        fail = exhausted & (~salvage)

        s_vec = xt - st.x
        y_vec = gt - g0
        sy = _dot(s_vec, y_vec)
        good = live & accept & (sy > 1e-10 * torch.linalg.norm(s_vec, dim=-1)
                                * torch.linalg.norm(y_vec, dim=-1))
        S = st.S.index_put((b, st.head), torch.where(
            good[:, None], s_vec, st.S[b, st.head]))
        Y = st.Y.index_put((b, st.head), torch.where(
            good[:, None], y_vec, st.Y[b, st.head]))
        rho = st.rho.index_put((b, st.head), torch.where(
            good, 1.0 / sy, st.rho[b, st.head]))
        head = torch.where(good, (st.head + 1) % m, st.head)
        n_corr = torch.where(good, torch.clamp(st.n_corr + 1, max=m),
                             st.n_corr)

        x_new = torch.where(accept[:, None], xt, st.x)
        f_new = torch.where(accept, ft, f0)
        g_new = torch.where(accept[:, None], gt, g0)
        # on a reject: Armijo failure means the step is too long (halve);
        # Armijo passed but the curvature failed means it is too short
        # (halving can never fix that), so grow
        grow = armijo & (~curv)
        step = torch.where(accept, step,
                           torch.where(grow, 2.0 * step, 0.5 * step))

        gnorm = torch.linalg.norm(g_new, dim=-1) / torch.clamp(
            torch.linalg.norm(x_new, dim=-1), min=1.0)
        conv_g = accept & (gnorm < g_epsilon)
        # the slot an accept overwrites was written `past` accepts ago
        slot = ((st.n_accept + 1) % past)[:, None]
        f_old = st.fpast.gather(1, slot)[:, 0]
        conv_f = accept & (st.n_accept >= past) & (
            (f_old - f_new) / torch.clamp(f_new.abs(), min=1.0)
            < rel_cost_tol)
        took = live & accept
        tslot = (st.it % trace_len)[:, None]
        st = LockState(
            x=torch.where(live[:, None], x_new, st.x),
            f=torch.where(live, f_new, st.f),
            g=torch.where(live[:, None], g_new, st.g),
            aux=_select(took, auxt, st.aux),
            d=torch.where(live[:, None], d, st.d),
            step=torch.where(live, step, st.step),
            ls_k=torch.where(live, torch.where(accept, 0, st.ls_k + 1),
                             st.ls_k),
            S=S, Y=Y, rho=rho, n_corr=n_corr, head=head,
            it=st.it + live,
            n_accept=st.n_accept + took,
            evals=st.evals + 2 * live,
            done=st.done | (live & (conv_g | conv_f | fail)),
            fpast=st.fpast.scatter(1, slot, torch.where(
                took, f_new, f_old)[:, None]),
            trace=st.trace.scatter(1, tslot, torch.where(
                live, f_new, st.trace.gather(1, tslot)[:, 0])[:, None]),
        )

    return LockstepResult(
        x=st.x, f=st.f, g=st.g, n_iters=st.n_accept, n_evals=st.evals,
        converged=st.done, aux=st.aux, history=st.trace, state=st,
        n_loops=max_loop,
    )
