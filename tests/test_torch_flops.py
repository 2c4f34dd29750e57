"""The sweep kernels' operation and byte counts (isdf_torch/utils/flops.py),
pinned for the cases of PERF.md's kernel table: moving them out of
chip_smoke.py changed no count, and a later change to a count must show
here."""

import pytest
import torch

import chip_smoke
from isdf_torch.config import Config
from isdf_torch.shapes import make_shape
from isdf_torch.sweep.grid_zoom import GridField
from isdf_torch.utils import flops


def test_k1_and_k4_counts_of_the_table():
    cone = make_shape("RoundedCone", Config(**chip_smoke.DEMO1))
    assert flops.k1_ops_per_query(cone, 128, 24) == 75434
    assert flops.k1_bound_ms(cone, 4096, 12, 128, 24) == pytest.approx(
        (0.004611606925373135, "operations", 308977664, 154560))
    # the swept-volume chunk: 65,536 points, the same work a query
    assert flops.k1_bound_ms(cone, 65536, 12, 128, 24)[2] == 65536 * 75434
    box = make_shape("Box", Config(**chip_smoke.DEMO8))
    assert flops.k1_ops_per_query(box, 64, 8, planar=True) == 11168
    assert flops.k1_bound_ms(box, 2048, 7, 64, 8, planar=True) == \
        pytest.approx((0.0003413740895522388, "operations", 22872064,
                       77360))
    assert flops.k4_ops_per_query(cone, 12) == 17256
    assert flops.k4_bound_ms(cone, 4096, 12, 12) == pytest.approx(
        (0.0010549339701492538, "operations", 70680576, 99264))


def test_k3_counts_of_the_table():
    # the bound reads the sizes of the L robot's field (57 × 45 × 31 at
    # demo 6's 0.05 m, tests/test_torch_mesh.py) and of its pooled twin
    grid = GridField.build(torch.zeros(57, 45, 31), (0.0, 0.0, 0.0), 0.05,
                           "cpu")
    assert tuple(grid.pooled_dims) == (29, 23, 16)
    assert flops.k3_ops(1, 4096, 128, 24) == 136118272
    assert flops.k3_ops(1, 4096, 64, 8, planar=True) == 39225792
    assert flops.k3_ops(1, 65536, 128, 24) == 2177646592
    assert flops.k3_bound_ms(grid, 4096, 12, 128, 24) == pytest.approx(
        (0.002031616, "operations", 136118272, 509164))


def test_bound_takes_the_larger_time():
    assert flops.bound_ms(67e9, 0) == pytest.approx(
        (1.0, "operations", 67e9, 0))
    assert flops.bound_ms(0, 3.35e10) == pytest.approx(
        (10.0, "bytes", 0, 3.35e10))


def test_k5_counts_of_the_table():
    # demo6.plan's call (P = 4096 times, N = 13) and the batch cells'
    # (B = 4096, P = 512, N = 4), float32, t's gradient not wanted
    assert flops.k5_bound_ms(1, 4096, 13) == pytest.approx(
        (9.877731343283582e-05, "bytes", 1314816, 330904))
    assert flops.k5_bound_ms(4096, 512, 4) == pytest.approx(
        (0.051294146865671644, "bytes", 673185792, 171835392))
    # float64 doubles the bytes; t's gradient adds a value a time
    assert flops.k5_bound_ms(1, 4096, 13, itemsize=8)[3] == 2 * 330904
    assert flops.k5_bound_ms(1, 4096, 13, want_t=True)[3] == \
        330904 + 4 * 4096
