"""isdf_torch's scenario-batched ``minimize_lockstep`` against isdf_tpu's,
float64 on the CPU.

The objective is a cheap analytic one that threads an aux through the
solver, as the swept penalty threads its t* warm starts: per scenario
f(x; aux) = Σ a (x − c)² + 0.05 Σ (x − c)⁴ + 0.01·aux·Σ x, aux treated as a
constant in the gradient, new_aux = 0.5·aux + 0.1·Σ x.  JAX runs each
scenario alone (un-vmapped); the port runs them as one batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.opt import lbfgs as jlbfgs

from isdf_torch.opt import lbfgs

B, NDIM = 5, 7
KW = dict(m=4, max_iters=30, g_epsilon=1e-9, past=3, rel_cost_tol=1e-14)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 30.0, size=(B, NDIM))
    a[0] = 1.0                  # scenario 0: well conditioned, converges early
    c = rng.normal(size=(B, NDIM))
    x0 = c + rng.normal(scale=2.0, size=(B, NDIM))
    x0[0] = c[0] + 0.05 * rng.normal(size=NDIM)
    aux0 = rng.normal(size=B)
    return a, c, x0, aux0


def _jax_cost(a, c):
    a, c = jnp.asarray(a), jnp.asarray(c)

    def cost_and_grad(x, aux):
        r = x - c
        f = jnp.sum(a * r * r) + 0.05 * jnp.sum(r ** 4) + 0.01 * aux * jnp.sum(x)
        g = 2.0 * a * r + 0.2 * r ** 3 + 0.01 * aux
        return f, g, 0.5 * aux + 0.1 * jnp.sum(x)

    return cost_and_grad


def _torch_cost(a, c):
    a, c = torch.as_tensor(a), torch.as_tensor(c)

    def cost_and_grad(x, aux):
        r = x - c
        sx = x.sum(-1)
        f = (a * r * r).sum(-1) + 0.05 * (r ** 4).sum(-1) + 0.01 * aux * sx
        g = 2.0 * a * r + 0.2 * r ** 3 + 0.01 * aux[:, None]
        return f, g, 0.5 * aux + 0.1 * sx

    return cost_and_grad


def _run_torch(a, c, x0, aux0, **kw):
    return lbfgs.minimize_lockstep(
        _torch_cost(a, c), torch.as_tensor(x0), torch.as_tensor(aux0),
        **{**KW, **kw})


def test_lockstep_follows_jax_per_scenario():
    """x and f to rtol 1e-9 (the two sum their dot products in different
    orders), the counts of accepted steps and evaluations exactly."""
    a, c, x0, aux0 = _problem()
    res = _run_torch(a, c, x0, aux0)
    assert res.n_loops == 2 * KW["max_iters"] + 8
    for b in range(B):
        rj = jlbfgs.minimize_lockstep(
            _jax_cost(a[b], c[b]), jnp.asarray(x0[b]), jnp.asarray(aux0[b]),
            **KW)
        np.testing.assert_allclose(res.x[b].numpy(), np.asarray(rj.x),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(float(res.f[b]), float(rj.f), rtol=1e-9)
        np.testing.assert_allclose(float(res.aux[b]), float(rj.aux),
                                   rtol=1e-9)
        assert int(res.n_iters[b]) == int(rj.n_iters)
        assert int(res.n_evals[b]) == int(rj.n_evals)
        assert bool(res.converged[b]) == bool(rj.converged)
        # JAX's `it` counts the trips the scenario was live in
        assert int(res.state.it[b]) == int(rj.state.it)
        hj = np.asarray(rj.history)
        ht = res.history[b].numpy()
        n = int(rj.state.it)
        np.testing.assert_allclose(ht[:n], hj[:n], rtol=1e-9)
        assert np.all(np.isnan(ht[n:]))


def test_batch_equals_each_scenario_alone():
    """A scenario's result does not depend on its neighbours: scenario 0
    converges within a few trips and is frozen while the others run."""
    a, c, x0, aux0 = _problem(seed=1)
    res = _run_torch(a, c, x0, aux0)
    its = res.state.it
    assert bool(res.converged[0]) and int(its[0]) < int(its.max())
    # frozen: two evaluations per live trip and the first one, no more
    assert torch.equal(res.n_evals, 1 + 2 * its)
    for b in range(B):
        one = _run_torch(a[b:b + 1], c[b:b + 1], x0[b:b + 1], aux0[b:b + 1])
        np.testing.assert_allclose(res.x[b].numpy(), one.x[0].numpy(),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(res.f[b]), float(one.f[0]),
                                   rtol=1e-12)
        assert int(res.n_iters[b]) == int(one.n_iters[0])
        assert int(res.n_evals[b]) == int(one.n_evals[0])
        assert bool(res.converged[b]) == bool(one.converged[0])


def test_resume_continues_the_solve():
    """Three chunks of 4 accepted steps, the state carried across, give
    what one call with 12 gives: a chunk boundary only freezes a scenario
    until the next chunk starts."""
    a, c, x0, aux0 = _problem(seed=2)
    whole = _run_torch(a, c, x0, aux0, max_iters=12)
    res = _run_torch(a, c, x0, aux0, max_iters=4, trace_len=16)
    for _ in range(2):
        res = lbfgs.minimize_lockstep(
            _torch_cost(a, c), res.x, res.aux,
            **{**KW, "max_iters": 4}, resume_state=res.state, trace_len=16)
    assert res.history.shape == (B, 16)
    torch.testing.assert_close(res.x, whole.x, rtol=0, atol=0)
    torch.testing.assert_close(res.f, whole.f, rtol=0, atol=0)
    assert torch.equal(res.n_iters, whole.n_iters)
    assert torch.equal(res.n_evals, whole.n_evals)


@pytest.mark.parametrize("max_ls", [1, 3])
def test_exhausted_search_salvages_or_fails(max_ls):
    """With a tiny trial budget the search is exhausted at once: a trial that
    decreased f is kept (salvage), one that did not ends the scenario."""
    a, c, x0, aux0 = _problem(seed=3)
    res = _run_torch(a, c, x0, aux0, max_ls=max_ls, max_iters=6)
    for b in range(B):
        rj = jlbfgs.minimize_lockstep(
            _jax_cost(a[b], c[b]), jnp.asarray(x0[b]), jnp.asarray(aux0[b]),
            **{**KW, "max_iters": 6}, max_ls=max_ls)
        np.testing.assert_allclose(float(res.f[b]), float(rj.f), rtol=1e-9)
        assert int(res.n_iters[b]) == int(rj.n_iters)
        assert bool(res.converged[b]) == bool(rj.converged)
