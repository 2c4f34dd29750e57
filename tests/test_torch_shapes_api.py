"""The array-of-structures SDF API of isdf_torch (primitives ``sphere`` …
``icosahedron``, combinators ``translate`` … ``bend_linear``) and the small
helpers ``minco.trajectory``, ``smoothing.cubic_hinge``,
``fast_eval.pvaj_all`` and ``fast_eval.sdf_at_time_fast`` against isdf_tpu,
float64 on the CPU, and tests/test_shapes.py's operator cases on the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import minco as jminco
from isdf_tpu.core import smoothing as jsm
from isdf_tpu.core.poly import PolyTraj as JPolyTraj
from isdf_tpu.shapes import make_shape as jmake_shape
from isdf_tpu.shapes import ops as jops
from isdf_tpu.shapes import primitives as jpr
from isdf_tpu.sweep import fast_eval as jfe

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, smoothing
from isdf_torch.core.poly import PolyTraj
from isdf_torch.shapes import make_shape, ops, primitives as pr
from isdf_torch.sweep import fast_eval

RNG = np.random.default_rng(0)
PTS = RNG.uniform(-1.5, 1.5, size=(256, 3))
GRID = RNG.uniform(-1.5, 1.5, size=(4, 5, 3))     # a leading shape of two
TOL = dict(rtol=0, atol=1e-12)
A = math.radians(50.0)

PRIMITIVES = {
    "sphere": (0.7,),
    "point": (),
    "box": ((0.5, 0.3, 0.2),),
    "rounded_box": ((0.5, 0.3, 0.2), 0.1),
    "wireframe_box": ((1.0, 0.8, 0.6), 0.1),
    "torus": (0.6, 0.2),
    "capped_torus": ((math.sin(A), math.cos(A)), 0.6, 0.15),
    "capsule": ((0.0, 0.0, -0.5), (0.1, 0.2, 0.5), 0.3),
    "cylinder": (0.4,),
    "capped_cylinder": (0.4, 0.5),
    "rounded_cylinder": (0.3, 0.1, 0.5),
    "capped_cone": ((0.0, 0.0, -0.5), (0.0, 0.2, 0.5), 0.5, 0.2),
    "rounded_cone": (0.5, 0.2, 1.0),
    "ellipsoid": ((0.6, 0.4, 0.3),),
    "plane": ((0.0, 0.6, 0.8), 0.1),
    "octahedron": (0.7,),
    "pyramid": (1.2,),
    "tetrahedron": (0.6,),
    "dodecahedron": (0.6,),
    "icosahedron": (0.6,),
}


def _rot(yaw, pitch):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    return Rz @ Ry


R = _rot(0.7, -0.4)


def _ease(t):
    return t * t


def _ops(o, pr_):
    """The 18 combinators of ``o`` over two primitives of ``pr_``."""
    f = lambda p: pr_.sphere(p, 0.8)                       # noqa: E731
    g = o.translate(lambda p: pr_.box(p, (0.4, 0.6, 0.3)), (0.6, 0.1, 0.0))
    h = lambda p: pr_.torus(p, 0.7, 0.2)                   # noqa: E731
    return {
        "translate": o.translate(f, (1.0, 0.5, -0.2)),
        "scale": o.scale(g, 1.7),
        "rotate": o.rotate(g, R),
        "transformed": o.transformed(g, R, (0.2, -0.3, 0.1)),
        "union": o.union(f, g, h),
        "intersection": o.intersection(f, g, h),
        "difference": o.difference(f, g),
        "smooth_union": o.smooth_union(f, g, 0.3),
        "smooth_intersection": o.smooth_intersection(f, g, 0.3),
        "smooth_difference": o.smooth_difference(f, g, 0.3),
        "blend": o.blend(f, g, 0.3),
        "negate": o.negate(g),
        "dilate": o.dilate(g, 0.2),
        "erode": o.erode(g, 0.2),
        "shell": o.shell(g, 0.05),
        "twist": o.twist(g, 0.8),
        "bend": o.bend(g, 0.5),
        "bend_linear": o.bend_linear(g, (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0),
                                     (0.0, 0.3, 0.1)),
        "bend_linear_ease": o.bend_linear(g, (0.0, -1.0, 0.0),
                                          (0.0, 1.0, 0.5), (0.2, 0.0, 0.3),
                                          ease=_ease),
    }


def test_every_public_name_has_its_counterpart():
    for jmod, tmod in ((jpr, pr), (jops, ops)):
        want = {n for n in vars(jmod) if not n.startswith("_")
                and n not in ("annotations", "math", "jnp", "Callable")}
        missing = {n for n in want if not hasattr(tmod, n)}
        assert not missing, (jmod.__name__, sorted(missing))
    assert len(PRIMITIVES) == 20


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_equals_jax(name):
    args = PRIMITIVES[name]
    for p in (PTS, GRID):
        dj = np.asarray(getattr(jpr, name)(jnp.asarray(p), *args))
        dt = getattr(pr, name)(torch.as_tensor(p), *args)
        assert dt.shape == p.shape[:-1]
        np.testing.assert_allclose(dt.numpy(), dj, **TOL, err_msg=name)


@pytest.mark.parametrize("name", sorted(_ops(ops, pr)))
def test_op_equals_jax(name):
    fj, ft = _ops(jops, jpr)[name], _ops(ops, pr)[name]
    for p in (PTS, GRID):
        dj = np.asarray(fj(jnp.asarray(p)))
        dt = ft(torch.as_tensor(p))
        assert dt.shape == p.shape[:-1]
        np.testing.assert_allclose(dt.numpy(), dj, **TOL, err_msg=name)


def test_op_gradient_equals_jax():
    """Autograd through the classic form's one stack per leaf, away from
    the min/max seams: a smooth union of posed, twisted shapes."""
    fj = _ops(jops, jpr)
    ft = _ops(ops, pr)
    cj = jops.smooth_union(fj["transformed"], fj["twist"], 0.4)
    ct = ops.smooth_union(ft["transformed"], ft["twist"], 0.4)
    gj = np.asarray(jax.grad(lambda p: cj(p).sum())(jnp.asarray(PTS)))
    x = torch.as_tensor(PTS).requires_grad_(True)
    (gt,) = torch.autograd.grad(ct(x).sum(), x)
    nudge = np.asarray(jax.grad(lambda p: cj(p).sum())(
        jnp.asarray(PTS + 1e-6)))
    smooth = np.all(np.abs(gj - nudge) < 1e-3, axis=1)
    assert smooth.mean() > 0.8
    np.testing.assert_allclose(gt.numpy()[smooth], gj[smooth], rtol=1e-9,
                               atol=1e-9)


# tests/test_shapes.py:160-195 on the port


def test_union_intersection():
    f = lambda p: pr.sphere(p, 1.0)                       # noqa: E731
    g = ops.translate(f, (3.0, 0, 0))
    p = torch.tensor([[3.0, 0.0, 0.0]], dtype=torch.float64)
    np.testing.assert_allclose(float(ops.union(f, g)(p)[0]), -1.0, atol=2e-6)
    assert float(ops.intersection(f, g)(p)[0]) > 0


def test_scale():
    f = ops.scale(lambda p: pr.sphere(p, 1.0), 2.0)
    p = torch.tensor([[4.0, 0.0, 0.0]], dtype=torch.float64)
    np.testing.assert_allclose(float(f(p)[0]), 2.0, atol=2e-6)


def test_shell_dilate_erode():
    f = lambda p: pr.sphere(p, 1.0)                       # noqa: E731
    p = torch.tensor([[2.0, 0.0, 0.0]], dtype=torch.float64)
    np.testing.assert_allclose(float(ops.dilate(f, 0.3)(p)[0]), 0.7,
                               atol=2e-6)
    np.testing.assert_allclose(float(ops.erode(f, 0.3)(p)[0]), 1.3,
                               atol=2e-6)
    np.testing.assert_allclose(float(ops.shell(f, 0.1)(p)[0]), 0.9,
                               atol=2e-6)


def test_smooth_union_bounds():
    f = lambda p: pr.sphere(p, 1.0)                       # noqa: E731
    g = ops.translate(f, (2.5, 0, 0))
    p = torch.as_tensor(RNG.normal(size=(32, 3)) * 2)
    assert torch.all(ops.smooth_union(f, g, 0.25)(p)
                     <= ops.union(f, g)(p) + 1e-9)


def _minco_inputs(s, N=4, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N - 1, 3)) * 2.0
    T = rng.uniform(0.6, 1.8, size=N)
    head = rng.normal(size=(3, s)) * 0.3
    tail = rng.normal(size=(3, s)) * 0.3
    head[:, 0], tail[:, 0] = 0.0, (5.0, 2.0, 1.0)
    return q, T, head, tail


@pytest.mark.parametrize("s", [2, 3, 4])
def test_minco_trajectory_equals_jax(s):
    """min-acc, min-jerk and min-snap: coefficients and the positions along
    the trajectory, rtol 1e-10."""
    q, T, head, tail = _minco_inputs(s)
    jt = jminco.trajectory(*(jnp.asarray(a) for a in (q, T, head, tail)), s)
    tt = minco.trajectory(*(torch.as_tensor(a) for a in (q, T, head, tail)),
                          s)
    assert isinstance(tt, PolyTraj) and tt.n_coef == 2 * s
    np.testing.assert_allclose(tt.coeffs.numpy(), np.asarray(jt.coeffs),
                               rtol=1e-10, atol=1e-10)
    ts = np.linspace(0.0, T.sum(), 37)
    np.testing.assert_allclose(tt.pos(torch.as_tensor(ts)).numpy(),
                               np.asarray(jt.pos(jnp.asarray(ts))),
                               rtol=1e-10, atol=1e-10)


def _traj_pair():
    q, T, head, tail = _minco_inputs(3, N=5, seed=2)
    c = np.asarray(jminco.solve(*(jnp.asarray(a)
                                  for a in (q, T, head, tail))))
    return (JPolyTraj(durations=jnp.asarray(T), coeffs=jnp.asarray(c)),
            PolyTraj(torch.as_tensor(T), torch.tensor(c)), T.sum())


@pytest.mark.parametrize("n_orders", [2, 3, 4])
def test_pvaj_all_equals_jax(n_orders):
    """Inside and past both ends of the trajectory, zero-padded to four."""
    jt, tt, total = _traj_pair()
    t = RNG.uniform(-0.3, total + 0.3, size=(7, 9))
    oj = jfe.pvaj_all(jt, jnp.asarray(t), n_orders)
    ot = fast_eval.pvaj_all(tt, torch.as_tensor(t), n_orders)
    assert len(ot) == 4
    for d, (a, b) in enumerate(zip(ot, oj)):
        assert a.shape == (7, 9, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-9, err_msg=f"order {d}")


@pytest.mark.parametrize("name", ["Ball", "CSG", "RoundedCone"])
def test_sdf_at_time_fast_equals_jax(name):
    """p_eva (P, 1, 3) against t (P, K), the quadrotor tilt pose."""
    kw = dict(poly_params=(0.1, 0.0, 0.2, 30.0, 0.0, 120.0))
    jt, tt, total = _traj_pair()
    p = RNG.uniform(-1.0, 6.0, size=(16, 1, 3))
    t = RNG.uniform(0.0, total, size=(16, 5))
    dj = jfe.sdf_at_time_fast(jmake_shape(name, JConfig(**kw)), jt,
                              jfl.FlatParams.from_config(JConfig()),
                              jnp.asarray(p), jnp.asarray(t))
    dt = fast_eval.sdf_at_time_fast(make_shape(name, Config(**kw)), tt,
                                    fl.FlatParams.from_config(Config()),
                                    torch.as_tensor(p), torch.as_tensor(t))
    assert dt.shape == (16, 5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-9,
                               atol=1e-9)


def test_cubic_hinge_equals_jax():
    x = np.concatenate([np.linspace(-2.0, 2.0, 41), [0.0]])
    vj = np.asarray(jsm.cubic_hinge(jnp.asarray(x)))
    gj = np.asarray(jax.vmap(jax.grad(jsm.cubic_hinge))(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    vt = smoothing.cubic_hinge(xt)
    (gt,) = torch.autograd.grad(vt.sum(), xt)
    np.testing.assert_allclose(vt.detach().numpy(), vj, rtol=0, atol=1e-15)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-15)
    assert float(vt[-2].detach()) == 8.0 and float(vt[0].detach()) == 0.0
