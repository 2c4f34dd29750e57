"""isdf_torch's sim/ and plan/goals.py against isdf_tpu's on the CPU,
float64, the same inputs through both packages; and the GridMap additions
they rely on (``shape``, ``sdf_value_grad``, a numpy ``index_to_world``).

Held here:
  * the quadrotor: step, a 100-step rollout, force_moments_to_rpm,
    so3_control and cmd_to_odom within 1e-10 (relative to the state's
    scale: motor speeds are ~1.6e4 rpm);
  * the depth renderer on tests/test_depth_render.py's wall scene: equal
    hit masks and depth within 1e-9.  JAX's ESDF is float64 there (its
    float32 distance transform times a float64 resolution); the port's is
    float32, so the port's map is given its ESDF in float64 (the same
    values: at resolution 0.5 the product is exact);
  * goals (host numpy in both packages): the same GoalPool decisions,
    assign_goal, ManualTakeOver, and sample_free_goals equal to the bit.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu import sim as jsim
from isdf_tpu.plan import goals as jgoals
from isdf_tpu.plan.traj_server import PositionCommand as JPositionCommand
from isdf_tpu.sim.quadrotor import force_moments_to_rpm as jforce_to_rpm
from isdf_tpu.world import GridMap as JGridMap
from isdf_tpu.world import maps_gen as jmaps_gen

from isdf_torch import sim
from isdf_torch.plan import goals
from isdf_torch.plan.traj_server import PositionCommand
from isdf_torch.sim.fake_drone import Odometry
from isdf_torch.sim.quadrotor import force_moments_to_rpm
from isdf_torch.world import GridMap

F64 = torch.float64


def _states(seed=0):
    """A perturbed hover state in both packages."""
    rng = np.random.default_rng(seed)
    p = jsim.QuadrotorParams()
    js = jsim.QuadState.hover(p, pos=jnp.array([0.3, -0.2, 1.0]))
    R = (np.eye(3) + 0.05 * np.array([[0, -1, 0.5], [1, 0, -0.3],
                                      [-0.5, 0.3, 0]]))
    u, _, vt = np.linalg.svd(R)
    fields = dict(vel=rng.normal(scale=0.3, size=3), R=u @ vt,
                  omega=rng.normal(scale=0.2, size=3),
                  motor_rpm=np.asarray(js.motor_rpm)
                  + rng.normal(scale=300.0, size=4))
    js = js._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = sim.QuadState(*(torch.tensor(np.asarray(v), dtype=F64)
                         for v in js))
    return p, sim.QuadrotorParams(), js, ts


def _close(t, j, what):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-10,
                               atol=1e-10 * max(1.0, float(np.abs(j).max())),
                               err_msg=what)


def test_hover_state_matches_jax():
    p = jsim.QuadrotorParams()
    js = jsim.QuadState.hover(p, pos=jnp.array([0.0, 0.0, 1.0]))
    ts = sim.QuadState.hover(sim.QuadrotorParams(), pos=[0.0, 0.0, 1.0],
                             device="cpu")
    for name, a, b in zip(ts._fields, ts, js):
        _close(a, b, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_step_matches_jax(seed):
    jp, tp, js, ts = _states(seed)
    cmd = np.asarray(js.motor_rpm) + np.random.default_rng(seed + 7).normal(
        scale=500.0, size=4)
    jn = jsim.quad_step(js, jnp.asarray(cmd), jp, dt=0.01)
    tn = sim.quad_step(ts, torch.as_tensor(cmd, dtype=F64), tp, dt=0.01)
    for name, a, b in zip(tn._fields, tn, jn):
        _close(a, b, name)


def test_rollout_matches_jax():
    jp, tp, js, ts = _states(2)
    cmds = (np.asarray(js.motor_rpm)[None]
            + np.random.default_rng(3).normal(scale=200.0, size=(100, 4)))
    jfin, jall = jsim.rollout(js, jnp.asarray(cmds), jp, dt=0.01)
    tfin, tall = sim.rollout(ts, torch.as_tensor(cmds, dtype=F64), tp,
                             dt=0.01)
    for name, a, b in zip(tfin._fields, tfin, jfin):
        _close(a, b, name)
    for name, a, b in zip(tall._fields, tall, jall):
        assert a.shape[0] == 100
        _close(a, b, name)


def test_mixer_and_controller_match_jax():
    jp, tp, js, ts = _states(4)
    rng = np.random.default_rng(5)
    for _ in range(3):
        des = [rng.normal(size=3) for _ in range(3)]
        yaw = float(rng.uniform(-3, 3))
        jt, jM = jsim.so3_control(js.pos, js.vel, js.R, js.omega,
                                  *(jnp.asarray(d) for d in des), yaw,
                                  jp.mass, jp.g, inertia=jp.inertia)
        tt, tM = sim.so3_control(ts.pos, ts.vel, ts.R, ts.omega,
                                 *(torch.as_tensor(d, dtype=F64)
                                   for d in des), yaw,
                                 tp.mass, tp.g, inertia=tp.inertia)
        _close(tt, jt, "thrust")
        _close(tM, jM, "moments")
        _close(force_moments_to_rpm(tt, tM, tp),
               jforce_to_rpm(jt, jM, jp), "rpm")
    # the tilt limit: a far horizontal target
    far = [np.array([50.0, 0.0, 1.0]), np.zeros(3), np.zeros(3)]
    jt, jM = jsim.so3_control(js.pos, js.vel, js.R, js.omega,
                              *(jnp.asarray(d) for d in far), 0.0,
                              jp.mass, jp.g)
    tt, tM = sim.so3_control(ts.pos, ts.vel, ts.R, ts.omega,
                             *(torch.as_tensor(d, dtype=F64) for d in far),
                             0.0, tp.mass, tp.g)
    _close(tt, jt, "thrust (tilt-limited)")
    _close(tM, jM, "moments (tilt-limited)")


def test_hover_hold_under_controller():
    """tests/test_sim.py's closed loop on the port, shortened: the drone
    climbs 0.5 m to its target and holds it."""
    p = sim.QuadrotorParams()
    s = sim.QuadState.hover(p, pos=[0.0, 0.0, 1.0], device="cpu")
    target = torch.tensor([0.0, 0.0, 1.5], dtype=F64)
    zero = torch.zeros(3, dtype=F64)
    for _ in range(800):
        thrust, M = sim.so3_control(s.pos, s.vel, s.R, s.omega, target,
                                    zero, zero, 0.0, p.mass, p.g,
                                    inertia=p.inertia)
        s = sim.quad_step(s, force_moments_to_rpm(thrust, M, p), p, dt=0.005)
    assert float(torch.linalg.norm(s.pos - target)) < 0.1


def test_cmd_to_odom_matches_jax():
    yaw = np.array([0.0, np.pi / 2, -2.5])
    pos, vel = np.arange(9.0).reshape(3, 3), np.ones((3, 3))
    z = np.zeros((3, 3))
    odom = sim.cmd_to_odom(PositionCommand(pos, vel, z, z, yaw, 0 * yaw))
    jodom = jsim.cmd_to_odom(JPositionCommand(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(z), jnp.asarray(z),
        jnp.asarray(yaw), jnp.asarray(0 * yaw)))
    assert isinstance(odom, Odometry)
    for a, b in zip(odom, jodom):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-10)


def _wall_maps():
    """tests/test_depth_render.py's scene: a wall slab at x ∈ [6, 7]."""
    ys, zs = np.meshgrid(np.arange(0.25, 10, 0.25), np.arange(0.25, 5, 0.25))
    pts = np.stack([np.full(ys.size, 6.5), ys.ravel(), zs.ravel()], axis=1)
    jgm = JGridMap.from_points(pts, (0, 10, 0, 10, 0, 5), 0.5, 1).with_esdf()
    gm = GridMap.from_points(pts, (0, 10, 0, 10, 0, 5), 0.5, 1,
                             device="cpu").with_esdf()
    return jgm, replace(gm, esdf=gm.esdf.double())


_TOWARD = np.stack([np.array([0, -1.0, 0]), np.array([0, 0, -1.0]),
                    np.array([1.0, 0, 0])], axis=1)      # camera z → +x
_AWAY = np.stack([np.array([0, 1.0, 0]), np.array([0, 0, -1.0]),
                  np.array([-1.0, 0, 0])], axis=1)       # camera z → −x


@pytest.mark.parametrize("pos,R,max_depth", [
    ((1.0, 5.0, 2.5), _TOWARD, 20.0),
    ((2.0, 3.0, 1.0), _TOWARD, 4.5),
    ((1.0, 5.0, 2.5), _AWAY, 8.0),
])
def test_render_depth_matches_jax(pos, R, max_depth):
    jgm, gm = _wall_maps()
    cam = sim.CameraIntrinsics.from_fov(32, 24, fov_x_deg=60.0)
    jcam = jsim.CameraIntrinsics.from_fov(32, 24, fov_x_deg=60.0)
    assert tuple(cam) == tuple(jcam)
    want = np.asarray(jsim.render_depth(jgm, jcam, np.asarray(pos), R,
                                        max_depth=max_depth))
    got = sim.render_depth(gm, cam, np.asarray(pos), R, max_depth=max_depth)
    assert got.shape == (24, 32) and got.dtype == F64
    got = got.numpy()
    np.testing.assert_array_equal(got < max_depth, want < max_depth)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)

    jpts, jvalid = jsim.render_pointcloud(jgm, jcam, np.asarray(pos), R,
                                          max_depth=max_depth)
    pts, valid = sim.render_pointcloud(gm, cam, np.asarray(pos), R,
                                       max_depth=max_depth)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=1e-9)


def test_gridmap_additions_match_jax():
    jgm, gm = _wall_maps()
    assert gm.shape == tuple(jgm.shape) == (20, 20, 10)
    p = np.random.default_rng(0).uniform([0, 0, 0], [10, 10, 5], (64, 3))
    jv, jg = jgm.sdf_value_grad(jnp.asarray(p))
    v, g = gm.sdf_value_grad(torch.as_tensor(p, dtype=F64))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-10)
    idx = np.array([[0, 0, 0], [3, 7, 2], [19, 19, 9]])
    w = gm.index_to_world(idx)
    assert isinstance(w, np.ndarray)
    np.testing.assert_array_equal(w, np.asarray(jgm.index_to_world(idx)))
    wt = gm.index_to_world(torch.as_tensor(idx))
    assert isinstance(wt, torch.Tensor)
    np.testing.assert_array_equal(wt.numpy(), w)


def _pools():
    g = np.array([[0, 0, 1.0], [5, 0, 1.0], [0, 5, 1.0], [5, 5, 1.0],
                  [2, 2, 2.0]])
    kw = dict(n_agents=3, arrive_radius=0.5, dwell_s=1.0, seed=3)
    return jgoals.GoalPool(g, **kw), goals.GoalPool(g, **kw)


def test_goal_pool_decisions_match_jax():
    jp, tp = _pools()
    rng = np.random.default_rng(0)
    now = 0.0
    issued = 0
    for step in range(120):
        agent = int(rng.integers(3))
        st = tp.agents[agent]
        # mostly sit at the current goal (arrive, dwell, get a new one),
        # now and then wander off
        if st.goal is None or rng.uniform() < 0.2:
            pos = rng.uniform(-1, 6, size=3)
        else:
            pos = st.goal + rng.normal(scale=0.1, size=3)
        now += float(rng.uniform(0.1, 0.8))
        a = jp.update(agent, pos, now=now)
        b = tp.update(agent, pos, now=now)
        assert (a is None) == (b is None), step
        if a is not None:
            issued += 1
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tp.occupied, jp.occupied)
        if step == 60:
            np.testing.assert_array_equal(
                goals.assign_goal(tp, 1, [7.0, 7.0, 2.0]),
                jgoals.assign_goal(jp, 1, [7.0, 7.0, 2.0]))
            np.testing.assert_array_equal(tp.occupied, jp.occupied)
    assert issued > 5


def test_manual_take_over_matches_jax():
    j, t = jgoals.ManualTakeOver(max_vel=0.2), goals.ManualTakeOver(
        max_vel=0.2)
    for m in (j, t):
        m.set_pose([1.0, 2.0, 3.0], yaw=0.5)
    rng = np.random.default_rng(1)
    for k in range(20):
        buttons = [int(k == 5), 0, 0, 0]
        axes = rng.uniform(-1.5, 1.5, size=4)
        assert t.feed_joy(buttons, axes) == j.feed_joy(buttons, axes)
        a, b = j.manual_command(0.1), t.manual_command(0.1)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
        assert t.filter_command("cmd") == j.filter_command("cmd")


@pytest.mark.parametrize("clearance", [0, 1])
def test_sample_free_goals_match_jax(clearance):
    pts = jmaps_gen.generate(5, res=0.4, seed=0)
    jgm = JGridMap.from_points(pts, (0, 60, 0, 60, 0, 35), 0.5)
    gm = GridMap.from_points(pts, (0, 60, 0, 60, 0, 35), 0.5, device="cpu")
    want = jgoals.sample_free_goals(jgm, 16, seed=0, clearance_vox=clearance)
    got = goals.sample_free_goals(gm, 16, seed=0, clearance_vox=clearance)
    assert isinstance(got, np.ndarray) and got.shape == (16, 3)
    np.testing.assert_array_equal(got, want)
    occ = gm.is_occupied(torch.as_tensor(got))
    assert not bool(occ.any())
