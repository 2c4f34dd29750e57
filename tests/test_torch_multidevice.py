"""The port's multi-device path (isdf_torch.parallel.mesh and the mesh-aware
entry points of parallel.batch) against the port without a mesh and against
JAX's unsharded batched solve, on the CPU: ranks are spawned processes in a
gloo process group joined through a file, float64, at tests/test_parallel.py's
sizes (Ball, N = 3, P = 16).  The ranks run tests/torch_mesh_ranks.py and
write their results; this process compares them.

JAX on the CPU sweeps through its non-fused XLA path (its fused kernel needs
the TPU), while the port on the CPU runs K2's plain version, the kernel's own
algorithm; at coarse 8 and rounds 3 the two pick other t* on warm sweeps, and
after three iterations the final costs are up to 58 % apart.  So the port is
held against JAX's solve through its non-fused path (a Ball without a device
SDF: JAX's CPU algorithm, equal to 1e-10), and the sharded solves against
the port without a mesh on both paths."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.parallel import batch as jpb
from isdf_tpu.shapes import make_shape as jmake_shape

import torch_mesh_ranks as tr
from isdf_torch.parallel import batch as pb
from isdf_torch.parallel import mesh as pm
from isdf_torch.parallel.dryrun import run_ranks
from isdf_torch.shapes import make_shape

JOIN_S = 120.0          # a hang fails one test, not the whole run
F_RTOL = 1e-8           # tests/test_parallel.py:27-38
C_RTOL, C_ATOL = 1e-6, 1e-8
MESHES = ("2x1", "1x2", "2x2")
OUT = tr.OUT


def _load(outdir, case, world):
    return [dict(np.load(outdir / f"{case}_r{r}.npz")) for r in range(world)]


def _spawn_all(out):
    for fn, world in ((tr.world1, 1), (tr.world2, 2), (tr.world4, 4)):
        run_ranks(fn, world, (str(out),), timeout=JOIN_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and JAX's unsharded batched_solve(max_iters=3):
    the ranks run while this process compiles JAX's solve."""
    out = tmp_path_factory.mktemp("ranks")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawn_all, out)
        jc = JConfig(**tr.CONF)
        jb = jpb.make_random_batch(jc, tr.B, N=tr.N, n_points=tr.P,
                                   dtype=jnp.float64)
        jax_out = [np.asarray(a) for a in jpb.batched_solve(
            jmake_shape("Ball", jc), jc, jb, max_iters=3)]
        spawned.result()
    return out, jax_out


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_solve(runs):
    return runs[1]


@pytest.fixture(scope="module")
def no_mesh(ranks):
    """The port's batched_solve(max_iters=3) without a mesh, both paths."""
    return {path: [_load(ranks, f"solve_none_{path}", 1)[0][k] for k in OUT]
            for path in ("fused", "nonfused")}


def _held(got, ref, what):
    np.testing.assert_array_equal(got["iters"], ref[3], err_msg=what)
    np.testing.assert_allclose(got["f"], ref[2], rtol=F_RTOL, err_msg=what)
    np.testing.assert_allclose(got["coeffs"], ref[0], rtol=C_RTOL,
                               atol=C_ATOL, err_msg=what)
    np.testing.assert_allclose(got["T"], ref[1], rtol=C_RTOL, atol=C_ATOL,
                               err_msg=what)


def test_port_without_mesh_matches_jax_batched_solve(no_mesh, jax_solve):
    _held(dict(zip(OUT, no_mesh["nonfused"])), jax_solve, "port vs JAX")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_solve_matches_no_mesh_and_jax(ranks, no_mesh, jax_solve,
                                               shape):
    """Every rank returns the whole batch's results, in scenario order,
    within the band of the unsharded solve: the port's on both sweep paths,
    JAX's on the path JAX runs here."""
    world = int(shape[0]) * int(shape[2])
    for path in ("fused", "nonfused"):
        for r, got in enumerate(_load(ranks, f"solve_{shape}_{path}",
                                      world)):
            what = f"{shape} {path} rank {r}"
            assert got["f"].shape == (tr.B,), what
            _held(got, no_mesh[path], what + " vs no mesh")
            if path == "nonfused":
                _held(got, jax_solve, what + " vs JAX")


def test_sp_cost_and_gradient(ranks):
    """(1, 2): each rank's t* equals the unsharded evaluation's on its
    points; f and g within 1e-12 of the unsharded ones and g identical on
    both ranks; g equal to central differences of the sharded cost at the
    frozen t* (a backward all-reduce in reduce_from_sp would double the
    penalty's share of g, a missing one in copy_to_sp would halve it)."""
    r0, r1 = _load(ranks, "sp_cost_grad", 2)
    c = tr.conf()
    sb = tr.batch(c)
    x, tw = torch.as_tensor(r0["x"]), torch.cat(
        [torch.as_tensor(r0["tw"]), torch.as_tensor(r1["tw"])], dim=1)
    f, g, t_star = pb._cost_fn(make_shape("Ball", c), c, sb)(x, tw)
    half = tr.P // 2
    for r, rec in enumerate((r0, r1)):
        block = t_star[:, r * half:(r + 1) * half].numpy()
        np.testing.assert_array_equal(rec["t_star"], block,
                                      err_msg=f"rank {r} t*")
        np.testing.assert_allclose(rec["f"], f.numpy(), rtol=1e-12, atol=0)
        np.testing.assert_allclose(rec["g"], g.numpy(), rtol=0,
                                   atol=1e-12 * float(g.abs().max()))
        np.testing.assert_array_equal(rec["f_frozen"], rec["f"])
        scale = np.abs(rec["g"]).max(axis=1, keepdims=True)
        assert np.all(np.abs(rec["fd"] - rec["g"]) <= 1e-6 * scale), (
            np.abs(rec["fd"] - rec["g"]).max())
    np.testing.assert_array_equal(r0["g"], r1["g"])
    np.testing.assert_array_equal(r0["f"], r1["f"])
    # the safety penalty is active, so the sp sum carries weight in g
    assert (f.numpy() > 1e3).all()


def test_dp_placement_equivariance_is_bitwise(ranks):
    """Rolling the scenarios by one moves each to the other rank: the same
    per-rank shapes give the rolled results bit for bit."""
    for r, rec in enumerate(_load(ranks, "equivariance", 2)):
        for k in OUT:
            np.testing.assert_array_equal(
                np.roll(rec[f"{k}_rolled"], -1, axis=0), rec[k],
                err_msg=f"rank {r} {k}")


def test_halves_converging_apart_stay_together(ranks):
    """Rank 0's scenarios all converge chunks before rank 1's: a rank that
    left the chunk loop on its own value would wait in a collective the
    other never enters.  The loop ends for both on the global value, and
    the accepted steps equal the solve without a mesh."""
    r0, r1 = _load(ranks, "converge_apart", 2)
    d0, d1 = r0["local_done"], r1["local_done"]
    assert len(d0) == len(d1)
    assert np.any(d0 & ~d1), (d0, d1)
    (ref,) = _load(ranks, "converge_none", 1)
    for rec in (r0, r1):
        np.testing.assert_array_equal(rec["iters"], ref["iters"])
        np.testing.assert_allclose(rec["f"], ref["f"], rtol=F_RTOL)


def test_audited_solve_on_a_dp_sp_mesh(ranks):
    """The unseen reserve voxel at (2, 2): the reserve pool split over dp,
    the injected slots over sp; the same violations per round and min SDF
    on every rank as without a mesh."""
    (ref,) = _load(ranks, "audited_none", 1)
    hist = ref["violations"].tolist()
    assert hist[0] > 0 and hist[-1] == 0, hist
    for r, rec in enumerate(_load(ranks, "audited_2x2", 4)):
        assert rec["violations"].tolist() == hist, (r, rec["violations"])
        np.testing.assert_allclose(rec["min_sdf"], ref["min_sdf"],
                                   rtol=C_RTOL, atol=C_ATOL)
        np.testing.assert_allclose(rec["f"], ref["f"], rtol=F_RTOL)
        np.testing.assert_array_equal(rec["iters"], ref["iters"])


def test_one_by_one_mesh_is_bitwise_no_mesh(ranks):
    (rec,) = _load(ranks, "world1", 1)
    for k in rec:
        if k.startswith("mesh_"):
            np.testing.assert_array_equal(
                rec[k], rec["none_" + k[len("mesh_"):]], err_msg=k)


def test_spawned_ranks_load_no_jax(ranks):
    for case, world in (("world1", 1), ("modules", 2)):
        for rec in _load(ranks, case, world):
            assert rec["modules"].size == 0, rec["modules"]


def _hand_mesh(shape, dp_idx=0, sp_idx=0):
    return pm.Mesh(shape=shape, dp_idx=dp_idx, sp_idx=sp_idx, dp_group=None,
                   sp_group=None, device=torch.device("cpu"))


def test_shard_batch_keeps_the_block_and_refuses_uneven_splits():
    c = tr.conf()
    sb = tr.batch(c)
    part = pm.shard_batch(sb, _hand_mesh((2, 2), dp_idx=1, sp_idx=0))
    assert torch.equal(part.q0, sb.q0[4:])
    assert torch.equal(part.points, sb.points[4:, :8])
    assert torch.equal(part.mask, sb.mask[4:, :8])
    assert part.mesh.shape == (2, 2)
    with pytest.raises(ValueError, match="already placed"):
        pm.shard_batch(part, _hand_mesh((2, 2)))
    with pytest.raises(ValueError, match="dp"):
        pm.shard_batch(tr.batch(c, B=3), _hand_mesh((2, 1)))
    with pytest.raises(ValueError, match="sp"):
        pm.shard_batch(tr.batch(c, P=15), _hand_mesh((1, 2)))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(device="cpu")
    # without a mesh the collectives are the identity
    x = torch.arange(4.0, requires_grad=True)
    y = pm.reduce_from_sp(pm.copy_to_sp(x, None), None)
    assert y is x
    assert pm.gather_dp(x, None) is x and pm.global_all(x > -1, None)


def test_nonfused_path_is_jax_s_cpu_path():
    """The Ball without a device SDF sweeps through the non-fused path."""
    from isdf_torch.sweep.sweep_sdf import kernel_ok

    shapes = tr.shapes(tr.conf())
    assert kernel_ok(shapes["fused"], 8)
    assert not kernel_ok(shapes["nonfused"], 8)
