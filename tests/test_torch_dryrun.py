"""isdf_torch.parallel.dryrun, the port's counterpart of the checks
in __graft_entry__.py: ``entry`` against JAX's ``entry`` on the CPU, and the
dryrun's sections (dp × sp cost+grad, the dp chunked solve's placement
equivariance, the grid shape's dp cost+grad, sp against unsharded) over
spawned gloo ranks joined through a file (JAX's dryrun_multichip) and over
TCP (its dryrun_multihost)."""

import pathlib
import socket
import sys

import jax
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import torch_mesh_ranks as tr
from isdf_torch.parallel import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECTIONS = ("section1_dp_sp_cost_grad", "section2_dp_chunked_equivariance",
            "section3_grid_dp_cost_grad", "section4_sp_against_unsharded")


def test_entry_matches_jax_entry():
    """One float32 cost+gradient evaluation, CappedCone, P = 256, from the
    same x0.  JAX sweeps through its non-fused path here and the port
    through K1's plain version: measured f within 6e-8, g within 2.5e-5 of
    its largest entry, t* equal on 254 of 256 points (two near-ties)."""
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    fj, gj, tj = (np.asarray(a) for a in jax.jit(fn)(*args))
    fn_t, args_t = dryrun.entry(device="cpu")
    np.testing.assert_array_equal(args_t[0].numpy(), np.asarray(args[0]))
    ft, gt, tt = (a.numpy() for a in fn_t(*args_t))
    assert ft.dtype == np.float32 and gt.shape == gj.shape
    np.testing.assert_allclose(ft, fj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * np.abs(gj).max())
    assert (tt == tj).mean() >= 0.99


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun(2, 2)


def test_dryrun_dp_sp_ranks_through_a_file():
    recs = dryrun.dryrun(world=4, sp=2, device="cpu", timeout=120.0)
    assert [r["rank"] for r in recs] == [0, 1, 2, 3]
    assert [(r["mesh"]["dp_idx"], r["mesh"]["sp_idx"]) for r in recs] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in recs:
        assert r["mesh"]["shape"] == [2, 2] and r["device"] == "cpu"
        assert all(s in r for s in SECTIONS)
        # CPU tensors run the kernels' plain versions: nothing launched
        assert all(r[s]["K2"] == 0 and r[s]["K3"] == 0 for s in SECTIONS)
        assert r["section4_rel_cost"] < 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dryrun_dp_ranks_over_tcp():
    """JAX's multi-host dryrun is the same function joined over TCP."""
    recs = dryrun.dryrun(world=2, sp=1, device="cpu", timeout=120.0,
                         init_method=f"tcp://127.0.0.1:{_free_port()}")
    assert [r["mesh"]["shape"] for r in recs] == [[2, 1], [2, 1]]
    assert recs[0]["section4_rel_cost"] == 0.0      # no sp: the same sums


def test_a_failing_rank_fails_the_run():
    """world 3 does not split into sp = 2: make_mesh raises in every rank,
    and run_ranks raises it here."""
    with pytest.raises(ProcessRaisedException, match="do not split"):
        dryrun.dryrun(world=3, sp=2, device="cpu", timeout=120.0)


def test_ranks_past_the_timeout_are_killed():
    with pytest.raises(TimeoutError):
        dryrun.run_ranks(tr.sleep_forever, 2, timeout=4.0)
