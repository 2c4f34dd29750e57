"""The frozen yardstick against the numbers PERF.md states and against the
program's copies it was taken from."""

import numpy as np
import pytest
import torch

from benchmark.frozen import batch_draws, busy, flops, maps, shapes


def test_k1_counts_pinned():
    # PERF.md: 42,790 operations a K1 query for CappedCone at coarse 64,
    # rounds 12; demo 1's posed RoundedCone at 128/24: 75,434
    assert flops.k1_ops_per_query("CappedCone", False, 64, 12) == 42790
    assert flops.k1_ops_per_query("RoundedCone", True, 128, 24) == 75434


def test_k2_bound_pinned():
    # PERF.md: K2's bound at B = 4096, P = 512, N = 4, 64/12 is 1.339 ms
    ops, nbytes = flops.k1_work("CappedCone", False, 4096, 512, 4, 64, 12)
    assert flops.bound_s(ops, nbytes) * 1e3 == pytest.approx(1.339, abs=5e-4)


@pytest.mark.parametrize("name", ["RoundedCone", "CappedCone", "Torus",
                                  "Box", "Blobby"])
def test_k1_counts_match_program(name):
    from isdf_torch.config import Config
    from isdf_torch.shapes import make_shape
    from isdf_torch.utils import flops as pf

    for poly in ((0.0,) * 6, (0.0, 0.0, 0.0, 120.0, 0.0, 0.0)):
        shape = make_shape(name, Config(poly_params=poly))
        posed = any(poly)
        assert flops.k1_ops_per_query(name, posed, 128, 24) == \
            pf.k1_ops_per_query(shape, 128, 24)


def test_k3_counts_match_program():
    from isdf_torch.utils import flops as pf

    assert flops.k3_ops(4096, 512, 128, 24) == pf.k3_ops(4096, 512, 128, 24)
    assert flops.k3_ops(1, 4096, 128, 24) == pf.k3_ops(1, 4096, 128, 24)


def test_draws_match_make_random_batch():
    from isdf_torch.config import Config
    from isdf_torch.parallel.batch import make_random_batch

    conf = Config()
    d = batch_draws.draw_batch(conf.inittime, 5, 4, 16, seed=3)
    b = make_random_batch(conf, 5, N=4, n_points=16, seed=3, device="cpu",
                          dtype=torch.float64)
    for k in ("head", "tail", "q0", "T0", "points", "mask"):
        assert np.array_equal(d[k], getattr(b, k).numpy()), k


def test_busy_union_matches_program():
    from isdf_torch.bench import busy_ns

    rng = np.random.default_rng(0)
    a = rng.integers(0, 1000, 50)
    spans = list(zip(a.tolist(), (a + rng.integers(1, 80, 50)).tolist()))
    assert busy.busy_ns(spans) == busy_ns(spans)
    gaps = busy.idle_gaps(spans, 0, 1200)
    assert sum(b - a for a, b in gaps) + busy.busy_ns(spans) == 1200


@pytest.mark.parametrize("name", ["map3", "map4"])
def test_maps_match_program(name):
    from isdf_torch.world import maps_gen

    assert np.array_equal(maps.MAPS[name](res=0.8, seed=0),
                          getattr(maps_gen, name)(res=0.8, seed=0))


def test_l_prism_matches_program():
    from isdf_torch.shapes import mesh

    V, F = shapes.l_prism(1.6, 1.0, 0.3)
    V2, F2 = mesh.l_prism()
    assert np.array_equal(V, V2) and np.array_equal(F, F2)
