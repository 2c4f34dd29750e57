"""isdf_torch shape zoo against isdf_tpu, float64 on the CPU.

Every registry shape, unposed and posed through ``poly_params``: value on
256 random points to atol 1e-9, and the autograd gradient against jax.grad
away from seams (a point counts as off a seam when JAX's own gradient moves
by less than 1e-3 under a 1e-6 nudge).  The three shapes with a device
description (shapes/spec.py) are also held against their zoo closures."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.shapes.zoo import SHAPE_REGISTRY as JREG

from isdf_torch.config import Config
from isdf_torch.shapes import SHAPE_REGISTRY, make_shape
from isdf_torch.shapes.spec import spec_sdf3

POSE = (0.3, -0.2, 0.1, 20.0, -35.0, 120.0)


def test_registry_names_match():
    assert list(SHAPE_REGISTRY) == list(JREG)
    assert len(SHAPE_REGISTRY) == 20


def _points(name, seed=0, n=256):
    rng = np.random.default_rng(seed)
    b = max(make_shape(name).bounds)
    return rng.uniform(-1.5 * b, 1.5 * b, size=(n, 3))


@pytest.mark.parametrize("posed", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPE_REGISTRY))
def test_shape_value_and_gradient(name, posed):
    kw = dict(poly_params=POSE) if posed else {}
    js, ts = jmake_shape(name, JConfig(**kw)), make_shape(name, Config(**kw))
    p = _points(name)
    dj = np.asarray(js.sdf(jnp.asarray(p)))
    dt = ts.sdf(torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-9, rtol=0)

    gj = np.asarray(js.grad(jnp.asarray(p)))
    nudge = np.random.default_rng(1).normal(size=p.shape) * 1e-6
    gj2 = np.asarray(js.grad(jnp.asarray(p + nudge)))
    smooth = np.all(np.abs(gj - gj2) < 1e-3, axis=1)
    assert smooth.mean() > 0.8, "too few points off the seams"
    gt = ts.grad(torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(gt[smooth], gj[smooth], atol=1e-7, rtol=1e-7)


@pytest.mark.parametrize("posed", [False, True])
@pytest.mark.parametrize("name", ["Ball", "RoundedCone", "CappedCone"])
def test_device_spec_matches_closure(name, posed):
    conf = Config(poly_params=POSE) if posed else Config()
    shape = make_shape(name, conf)
    assert shape.spec is not None and shape.spec.posed == posed
    p = torch.as_tensor(_points(name, seed=2))
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    np.testing.assert_allclose(spec_sdf3(shape.spec, x, y, z).numpy(),
                               shape.sdf3(x, y, z).numpy(), atol=1e-12,
                               rtol=0)


def test_shapes_without_device_spec():
    with_spec = {n for n in SHAPE_REGISTRY if make_shape(n).spec is not None}
    assert with_spec == {"Ball", "RoundedCone", "CappedCone"}
