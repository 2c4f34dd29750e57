"""The CUDA-graph lifecycle of ``isdf_torch.opt.graphs``, held on both stages
that keep a ``GraphCache``: the back end (``backend.GRAPHS``, entries owned
by ``SplitCost``) and the mid end (``midend.GRAPHS``, by ``MidCost``).

On the CPU: the cache is a small LRU whose entries keep the owner that made
them, a new key warms up eagerly, and a capture that raises leaves its key
eager for good.  On the card (``cuda``): a capture that raises in Python or
in CUDA leaves its key eager with the eager answers, counts one failure,
gives back the caller's stream and linear algebra, and leaves the random
generators out of capture mode."""

from dataclasses import replace

import pytest
import torch

import test_torch_backend_graph as bg
import test_torch_midend_graph as mg
from isdf_torch.opt import backend, graphs, midend
from isdf_torch.opt.graphs import GraphCache


def _back_end():
    """(the stage's module, problem(N, seed, **weights) → (owner, key), the
    arguments of one evaluation's graphs)."""
    args, _, x, tw, data = bg._problem("Ball")
    shape, params, w = args[:3]

    def problem(n, seed=0, **weights):
        d = data if seed == 0 else bg._problem("Ball", seed=seed)[4]
        split = backend.SplitCost(shape, params, replace(w, **weights), n,
                                  8, 64, 4)
        return split, split.key(torch.zeros(4 * n - 3, dtype=bg.F64), d)
    return backend, problem, (x, tw, data)


def _mid_end():
    def problem(n, seed=0, **weights):
        (_, _), x, (_, _, wps, refs) = mg._cost_fn(N=n, seed=seed)
        cost = mg._mid_cost(n, **weights)
        return cost, cost.key(x, wps, refs)
    (_, _), x, tensors = mg._cost_fn()
    return midend, problem, (x,) + tensors


STAGES = {"back_end": _back_end, "mid_end": _mid_end}
OTHER = {"back_end": dict(weight_p=1.0), "mid_end": dict(weight_pr=10.0)}


@pytest.mark.parametrize("stage", list(STAGES))
def test_graph_cache_is_a_small_lru(stage):
    """One entry a key, the least recently used first out beyond
    ``GRAPH_KEYS``; an entry keeps the owner that made it (the back end's,
    and with it its shape); two problems of one key share its entry, other
    settings make another; a new key's first ``WARMUP`` evaluations run
    eagerly."""
    module, problem, args = STAGES[stage]()
    cache = GraphCache(module.GRAPHS.make)
    made = [problem(n) for n in range(2, 3 + graphs.GRAPH_KEYS)]
    entries = [cache.entry(key, owner) for owner, key in made[:-1]]
    assert len(cache.entries) == graphs.GRAPH_KEYS
    owner, key = problem(2, seed=5)
    assert owner is not made[0][0] and key == made[0][1]
    assert cache.entry(key, owner) is entries[0]
    assert entries[0].owner is made[0][0]
    cache.entry(made[-1][1], made[-1][0])
    kept = list(cache.entries.values())
    assert len(kept) == graphs.GRAPH_KEYS
    assert entries[0] in kept and entries[1] not in kept
    owner, key = problem(2, **OTHER[stage])
    assert cache.entry(key, owner) is not entries[0]
    assert [cache.run(entries[0], args, lambda: "eager")
            for _ in range(graphs.WARMUP)] == [("eager", "eager")] * \
        graphs.WARMUP
    assert entries[0].graphs is None
    assert cache.evals == {"replay": 0, "capture": 0,
                           "eager": graphs.WARMUP}


@pytest.mark.parametrize("stage", list(STAGES))
def test_a_capture_that_raises_leaves_its_key_eager(stage, monkeypatch):
    """The capture's error is kept on the entry and counted once; the key
    then runs eagerly for good and holds no graphs."""
    module, problem, args = STAGES[stage]()

    def broken(graph, fn, pool=None):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(module, "capture", broken)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    cache = GraphCache(module.GRAPHS.make)
    owner, key = problem(4)
    entry = cache.entry(key, owner)
    n = graphs.WARMUP + 3
    got = [cache.run(entry, args, lambda: "eager") for _ in range(n)]
    assert got == [("eager", "eager")] * n
    assert cache.failures == 1 and str(entry.error) == "capture refused"
    assert entry.graphs is None
    assert cache.evals == {"replay": 0, "capture": 0, "eager": n}


# ---------------------------------------------------------------------------
# on the card

def _refuse(module, name, how, monkeypatch):
    """``module.name`` refuses to be captured: while the stream captures it
    raises (``python``) or synchronises (``cuda_sync``); → the original."""
    real = getattr(module, name)

    def refused(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            if how == "python":
                raise RuntimeError("refused while capturing")
            torch.cuda.synchronize()
        return real(*a, **k)
    monkeypatch.setattr(module, name, refused)
    return real


def _back_end_refused(how, monkeypatch):
    """Demo 6's back-end evaluations with the capture refused → (their (f,
    g), a function giving the one-piece evaluation's of the same inputs)."""
    args, kw, x, tw, _ = bg._card_problem("K3-demo6")
    real = _refuse(backend, "integral_penalty", how, monkeypatch)
    got = bg._evals(backend.make_cost_fn(*args, **kw), x, tw,
                    graphs.WARMUP + 3)

    def eager():
        monkeypatch.setattr(backend, "integral_penalty", real)
        return [bg._one_piece(args, kw, bg._x(x, i), tw_i)[:2]
                for i, (_, _, _, tw_i) in enumerate(got)]
    return [r[:2] for r in got], eager


def _mid_end_refused(how, monkeypatch):
    """The same for the mid end at N = 12 with the attitude term."""
    real = _refuse(midend, "attitude_penalty", how, monkeypatch)
    (cg, _), x, tensors = mg._cost_fn(N=12, device=mg._card(),
                                      dtype=torch.float32, conf=mg.CARD_CONF)
    got = [cg(mg._x(x, i), None)[:2] for i in range(graphs.WARMUP + 3)]

    def eager():
        monkeypatch.setattr(midend, "attitude_penalty", real)
        cost = mg._mid_cost(12, conf=mg.CARD_CONF)
        return [cost.value_and_grad(mg._x(x, i), *tensors)
                for i in range(len(got))]
    return got, eager


REFUSED = {"back_end": (backend, _back_end_refused),
           "mid_end": (midend, _mid_end_refused)}


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["python", "cuda_sync"])
@pytest.mark.parametrize("stage", list(REFUSED))
def test_a_failed_capture_falls_back_to_eager(stage, how, monkeypatch):
    """A capture that raises, in Python or in CUDA (a synchronisation
    while capturing), leaves its key eager with the eager answers, counts
    one failure, and a later random draw on the card still works."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graphs replay there only)")
    module, refused = REFUSED[stage]
    cache = GraphCache(module.GRAPHS.make)
    monkeypatch.setattr(module, "GRAPHS", cache)
    got, eager = refused(how, monkeypatch)
    assert cache.failures == 1
    assert cache.evals == {"replay": 0, "capture": 0, "eager": len(got)}
    (entry,) = cache.entries.values()
    assert entry.error is not None and entry.graphs is None
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert torch.backends.cuda.preferred_linalg_library() == \
        torch._C._LinalgBackend.Default
    torch.randn(3, device="cuda")      # the generators left capture mode
    for (f, g), (fe, ge) in zip(got, eager()):
        assert torch.equal(f, fe) and torch.equal(g, ge)
