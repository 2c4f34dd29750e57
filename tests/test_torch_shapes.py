"""isdf_torch shape zoo against isdf_tpu, float64 on the CPU.

Every registry shape, unposed and posed through ``poly_params``: value on
256 random points to atol 1e-9, and the autograd gradient against jax.grad
away from seams (a point counts as off a seam when JAX's own gradient moves
by less than 1e-3 under a 1e-6 nudge).  Every shape's device description
(shapes/spec.py) is also held against its zoo closure in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.shapes.zoo import SHAPE_REGISTRY as JREG

from isdf_torch.config import Config
from isdf_torch.shapes import SHAPE_REGISTRY, make_shape
from isdf_torch.shapes.spec import KINDS, MAX_PARAMS, spec_sdf3

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
@pytest.mark.parametrize("name", sorted(SHAPE_REGISTRY))
def test_device_spec_matches_closure(name, posed):
    """spec_sdf3 (the plain form of the device SDF) against the port's
    closure and against the JAX closure, float64: rtol 1e-9 (atol 1e-12 for
    values at the surface)."""
    kw = dict(poly_params=POSE) if posed else {}
    shape = make_shape(name, Config(**kw))
    assert shape.spec is not None and shape.spec.posed == posed
    pn = _points(name, seed=2)
    p = torch.as_tensor(pn)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    d = spec_sdf3(shape.spec, x, y, z).numpy()
    np.testing.assert_allclose(d, shape.sdf3(x, y, z).numpy(), rtol=1e-9,
                               atol=1e-12)
    j3 = jmake_shape(name, JConfig(**kw)).sdf3_fn()
    dj = np.asarray(j3(*(jnp.asarray(pn[:, c]) for c in range(3))))
    np.testing.assert_allclose(d, dj, rtol=1e-9, atol=1e-12)


def test_device_spec_gradient_matches_closure():
    """The device SDF's gradient is the derivative of the same arithmetic:
    autograd through spec_sdf3 equals autograd through the closure."""
    for name in sorted(SHAPE_REGISTRY):
        shape = make_shape(name, Config(poly_params=POSE))
        p = torch.as_tensor(_points(name, seed=3, n=64))
        q = [p[:, c].clone().requires_grad_(True) for c in range(3)]
        g_spec = torch.autograd.grad(spec_sdf3(shape.spec, *q).sum(), q,
                                     allow_unused=True)
        g_zoo = torch.autograd.grad(shape.sdf3(*q).sum(), q,
                                    allow_unused=True)
        for a, b in zip(g_spec, g_zoo):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=name)


def test_shapes_without_device_spec():
    """Every zoo shape has a device description; shapes that differ only in
    constants share a kind; the constants fit the device struct."""
    specs = {n: make_shape(n).spec for n in SHAPE_REGISTRY}
    assert all(s is not None for s in specs.values())
    assert all(len(s.params) <= MAX_PARAMS for s in specs.values())
    assert {s.kind for s in specs.values()} == set(KINDS)
    assert specs["Torus"].kind == specs["Torus_big"].kind
    assert specs["Torus"].params != specs["Torus_big"].params
    assert specs["BendLinear"].kind == specs["BendLinear_big"].kind
    assert (specs["SmoothDifference"].kind
            == specs["SmoothIntersection"].kind
            == specs["SmoothIntersection_big"].kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_capped_cone_gradient_on_its_cap(dtype):
    """A point on a flat cap (paba = 0 inside the radius: the squared
    distance the reference's metric takes the root of is exactly 0): the
    value of JAX's CappedCone, and a finite gradient, 0 as the kernel's dual
    numbers give it, in the zoo closure and in the device description's
    plain form.  jax.grad gives NaN there (sqrt's infinite slope times the
    clamp's 0), and through the swept penalty it made a scenario's whole
    cost gradient NaN (the bench's B = 512 batch, scenario 304, float32)."""
    p = np.array([[0.5, 0.0, -1.0], [0.5, 0.0, -1.5]])
    ts = make_shape("CappedCone", Config())
    js = jmake_shape("CappedCone", JConfig())
    pt = torch.as_tensor(p, dtype=dtype)
    np.testing.assert_allclose(ts.sdf(pt).numpy(),
                               np.asarray(js.sdf(jnp.asarray(p))),
                               rtol=1e-6)
    g = ts.grad(pt)
    assert torch.equal(g[0], torch.zeros(3, dtype=dtype))
    assert torch.isfinite(g).all() and g[1, 2] < 0
    q = pt.clone().requires_grad_(True)
    d = spec_sdf3(ts.spec, q[:, 0], q[:, 1], q[:, 2])
    (gs,) = torch.autograd.grad(d.sum(), q)
    torch.testing.assert_close(gs, g)
