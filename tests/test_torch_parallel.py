"""The port's parallel layer (``quadruped_locomotion_tpu_torch/parallel/``)
against the JAX package's ``parallel/``.

The JAX outputs are the committed ``parallel/`` section of
``tests/data/torch_port_slice8_refs.npz``
(``scripts/make_torch_port_references.py --file slice8``): the JAX sharded
sweep, kernel trace, balance rollout and closed loop on an 8-device mesh,
with their inputs. ``-m slow`` recomputes them live.

The port's side runs in a real process group: two spawned ranks on the
CPU (gloo, a ``FileStore`` under pytest's temporary directory, one thread
each, a 90 s limit), which run every sharded function on their halves of
the inputs and gather the results; rank 0 then runs them again on a
one-rank mesh of the same group (rank 1 waits), for the world-1 results.
Nothing here runs JAX unless ``-m slow``.

Tolerances:

* the generic sweep against the JAX sweep: ``tests/test_parallel.py``'s
  (realized wrench within 0.05, objective within rtol 1e-4 / atol 1e-3;
  the reduced error against the mean of the gathered solutions' errors
  within rtol 1e-3);
* the kernel's plain version, per shard, against the JAX kernel trace
  (15 iterations): the objective within ``tests/test_parallel.py``'s
  sweep tolerance (rtol 1e-4, atol 1e-3) and the honest KKT under
  ``tests/test_torch_fd_qp.py``'s stance gate (5e-3). That file's
  relative objective gate (|Δ| / (1 + |ref|) < 1e-4) is missed on one
  instance of the 64 (1.24e-4: objectives 4.1752 and 4.1758, both
  converged, KKT 1.4e-7 and 1.2e-7): two float32 optima of the W = 1e-4
  valley, ~3 N apart in the forces. Both sides are compared after 15
  iterations, not the 2 of ``tests/test_parallel.py``'s per-device trace
  check: after 1-3 iterations the instances are unconverged (KKT 1-11)
  and the plain version and the trace part by up to 91 N from the same G
  (a CPU run): the iterates start in that valley (κ(G) ≈ 4e5, ROADMAP.md
  §3), where the first steps magnify one rounding difference (``rsqrt``)
  and only convergence brings the two back together;
* the rollouts: the gates of ``__graft_entry__.py``'s sharded-vs-single
  check (base position within 1e-4 m, joints within 1e-3 rad, upright
  fraction equal);
* two ranks against one: bit for bit (each instance's arithmetic on the
  CPU does not depend on the batch it sits in, at these sizes).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.parallel import distributed as pdist
from quadruped_locomotion_tpu_torch.parallel import mesh as pmesh

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
RANK_TIMEOUT_S = 90.0
POS_GATE = 1e-4  # m, __graft_entry__.py's sharded-vs-single gates
Q_GATE = 1e-3  # rad
OBJECTIVE = dict(rtol=1e-4, atol=1e-3)  # tests/test_parallel.py's sweep gate
KKT_GATE = 5e-3  # tests/test_torch_fd_qp.py's stance-class honest-KKT gate
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


def _load_refs() -> dict:
    with np.load(make_refs.SLICE8_OUT) as f:
        return {k[len("parallel/"):]: f[k] for k in f.files}


def _problem(refs: dict, name: str):
    return tuple(torch.from_numpy(refs[f"inputs/{name}/{k}"]) for k in "AbSWDd")


def _objective(A, b, S, W, x):
    r = np.einsum("bij,bj->bi", A, x) - b
    return (S * r * r).sum(-1) + (W * x * x).sum(-1)


# --------------------------------------------------------------------------
# what every rank runs
# --------------------------------------------------------------------------


def _run_sharded(mesh, refs: dict, pod=None) -> dict:
    """Every sharded function on this rank's shard of the committed inputs,
    gathered back to the whole batch (numpy)."""
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout.closed_loop import (
        Command, LocomotionState,
    )
    from quadruped_locomotion_tpu_torch.rollout.simulator import SimState
    from quadruped_locomotion_tpu_torch.types import BaseTarget

    def inputs(cls, name):
        return convert.from_numpy(cls, convert.unflatten(refs, f"inputs/{name}/"),
                                  "cpu")

    out = {}
    sweep = pdist.make_sharded_qp_sweep(mesh, iters=make_refs.FD_ITERS,
                                        backend="generic")
    sol, kkt, err = sweep(*pdist.shard_problem(mesh, _problem(refs, "sweep")))
    sol = pmesh.gather_batch(mesh, sol)
    out.update({"sweep/x": sol.x, "sweep/kkt": sol.kkt_error,
                "sweep/global_kkt": kkt, "sweep/global_err": err})

    A, b, S, W, D, d = pdist.shard_problem(mesh, _problem(refs, "kernel"))
    x, _, _, kkt = fk.solve_weighted_ls_fd_qp(
        A, S, b, W, D, d, iters=make_refs.FD_ITERS)
    out.update({"kernel/x": pmesh.gather_batch(mesh, x),
                "kernel/kkt": pmesh.gather_batch(mesh, kkt)})

    roll = pmesh.make_sharded_rollout(mesh, make_refs.PAR_STEPS)
    final, err, kkt = roll(pmesh.shard_batch(mesh, inputs(SimState, "sims")),
                           pmesh.shard_batch(mesh, inputs(BaseTarget, "targets")))
    out.update({"rollout/final": pmesh.gather_batch(mesh, final),
                "rollout/err": err, "rollout/kkt": kkt})

    loco = pmesh.make_sharded_locomotion_rollout(mesh, make_refs.PAR_TICKS,
                                                 qp_backend="generic")
    final, kkt, upright = loco(
        pmesh.shard_batch(mesh, inputs(LocomotionState, "ls0")),
        pmesh.shard_batch(mesh, inputs(Command, "cmd")))
    out.update({"loco/final": pmesh.gather_batch(mesh, final),
                "loco/kkt": kkt, "loco/upright": upright})

    if pod is not None:
        sweep = pdist.make_sharded_qp_sweep(pod, iters=make_refs.FD_ITERS,
                                            backend="generic")
        sol, kkt, err = sweep(*pdist.shard_problem(pod, _problem(refs, "sweep")))
        out.update({"pod/x": pmesh.gather_batch(pod, sol.x),
                    "pod/global_kkt": kkt, "pod/global_err": err})
    out["launches"] = fk.launches
    return convert.to_numpy(out)


def _rank_work(rank: int) -> dict:
    """One rank of the two: join, build the meshes, run everything on two
    ranks, then on rank 0 alone, then the measurements."""
    torch.set_num_threads(1)
    refs = _load_refs()
    res = {"joined": [pdist.initialize_multihost(),
                      pdist.initialize_multihost()],
           "rank": dist.get_rank(), "world": dist.get_world_size()}
    mesh = pmesh.make_mesh(device="cpu")
    pod = pdist.make_pod_mesh(device="cpu")
    one = pmesh.make_mesh(1, device="cpu")
    res.update(mesh_shape=mesh.shape, mesh_rank=mesh.rank, pod_shape=pod.shape,
               pod_axes=pod.axis_names, one_rank=one.rank)
    res["two"] = _run_sharded(mesh, refs, pod)
    if one.rank is not None:
        res["one"] = _run_sharded(one, refs)
    small = tuple(t[:8] for t in _problem(refs, "sweep"))
    res["scaling"] = pdist.measure_scaling(small, iters=10, reps=2,
                                           device_counts=[1, 2], device="cpu")
    res["overhead"] = pdist.measure_sharding_overhead(small, iters=10, reps=2,
                                                      mesh=mesh)
    return res


def _rank_fails(rank: int, how: str) -> int:
    """Rank 0 returns; rank 1 raises or hangs."""
    if rank == 1:
        if how == "raises":
            raise ValueError("rank one fails")
        time.sleep(120)
    return rank


@pytest.fixture(scope="module")
def refs():
    return _load_refs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pdist.run_local_ranks(_rank_work, WORLD, device="cpu",
                                 timeout=RANK_TIMEOUT_S,
                                 tmp_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture
def world_one():
    """A world-1 gloo group in this process, made by the test through
    ``make_mesh`` and taken down after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# meshes, sharding, joining
# --------------------------------------------------------------------------


def test_world_one_mesh(world_one):
    with pytest.raises(ValueError, match="need 2 devices"):
        pmesh.make_mesh(2, device="cpu")
    mesh = pmesh.make_mesh(device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert (mesh.axis_names, mesh.shape, mesh.rank, mesh.size) == (
        (pmesh.DATA_AXIS,), (1,), 0, 1)
    assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        pmesh.make_mesh(2, device="cpu")
    pod = pdist.make_pod_mesh(device="cpu")
    assert pod.axis_names == (pdist.DCN_AXIS, pdist.ICI_AXIS)
    assert pod.shape == (1, 1) and pod.rank == 0
    x = torch.arange(6.0)
    assert torch.equal(pmesh.gather_batch(mesh, pmesh.shard_batch(mesh, x)), x)
    assert torch.equal(pmesh.replicate(mesh, {"x": x})["x"], x)
    assert float(pmesh.psum(mesh, torch.tensor(2.5))) == 2.5
    pmesh.shard_rollout_step(mesh, batch=2, steps=1)


@pytest.mark.parametrize("rank", range(4))
def test_block_sharding_in_rank_order(rank):
    mesh = pmesh.Mesh((pmesh.DATA_AXIS,), (4,), rank, 4, torch.device("cpu"),
                      "gloo", None)
    tree = {"a": torch.arange(8).reshape(8, 1), "b": (torch.arange(8.0),)}
    got = pmesh.shard_batch(mesh, tree)
    assert got["a"].flatten().tolist() == [2 * rank, 2 * rank + 1]
    assert got["b"][0].tolist() == [2.0 * rank, 2.0 * rank + 1]
    with pytest.raises(ValueError, match="does not split evenly"):
        pmesh.shard_batch(mesh, torch.zeros(6))
    with pytest.raises(ValueError, match="does not split evenly"):
        pmesh.shard_batch(mesh, torch.zeros(()))


def test_outside_the_mesh_raises():
    mesh = pmesh.Mesh((pmesh.DATA_AXIS,), (1,), None, 2, torch.device("cpu"),
                      "gloo", None)
    with pytest.raises(ValueError, match="outside the mesh"):
        pmesh.shard_batch(mesh, torch.zeros(2))


def test_initialize_multihost_without_environment(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize_multihost() is False
    assert not dist.is_initialized()


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    for call in (pmesh.make_mesh, pdist.make_pod_mesh, pmesh.rank_device,
                 lambda: pdist.initialize_multihost(init_method="file:///x")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not dist.is_initialized()


@pytest.mark.parametrize("how", ["raises", "hangs"])
def test_a_failed_rank_fails_the_call(tmp_path, how):
    """Nothing is caught and passed: a rank's exception reaches the caller
    with its traceback, and a hung rank is killed at the timeout."""
    err = (RuntimeError, "(?s)rank 1 failed.*ValueError: rank one fails") \
        if how == "raises" else (TimeoutError, r"ranks \[(0, )?1\] still running")
    t0 = time.monotonic()
    with pytest.raises(err[0], match=err[1]) as info:
        pdist.run_local_ranks(_rank_fails, WORLD, (how,), device="cpu",
                              timeout=4.0, tmp_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60
    assert "Traceback" in str(info.value) or how == "hangs"
    assert not list(tmp_path.iterdir())  # the store directory is gone


# --------------------------------------------------------------------------
# two ranks: the group
# --------------------------------------------------------------------------


def test_ranks_joined_one_group(ranks):
    for r, res in enumerate(ranks):
        assert res["joined"] == [True, True]  # idempotent
        assert (res["rank"], res["world"]) == (r, WORLD)
        assert res["mesh_shape"] == (WORLD,) and res["mesh_rank"] == r
        assert res["pod_shape"] == (1, WORLD)
        assert res["pod_axes"] == (pdist.DCN_AXIS, pdist.ICI_AXIS)
    assert ranks[0]["one_rank"] == 0 and ranks[1]["one_rank"] is None
    assert "one" in ranks[0] and "one" not in ranks[1]


@pytest.mark.parametrize("key", ["sweep/global_kkt", "sweep/global_err",
                                 "rollout/err", "rollout/kkt", "loco/kkt",
                                 "loco/upright", "pod/global_kkt"])
def test_every_rank_holds_the_global_metrics(ranks, key):
    np.testing.assert_array_equal(ranks[0]["two"][key], ranks[1]["two"][key])


def test_gathered_batches_agree_across_ranks(ranks):
    for key in ("sweep/x", "kernel/x", "pod/x"):
        np.testing.assert_array_equal(ranks[0]["two"][key], ranks[1]["two"][key])
    np.testing.assert_array_equal(
        ranks[0]["two"]["loco/final"]["sim"]["robot"]["q"],
        ranks[1]["two"]["loco/final"]["sim"]["robot"]["q"])


def test_no_kernel_launch_on_the_cpu(ranks):
    assert all(res["two"]["launches"] == 0 for res in ranks)


# --------------------------------------------------------------------------
# two ranks against the JAX package
# --------------------------------------------------------------------------


def test_generic_sweep_matches_jax(ranks, refs):
    got = ranks[0]["two"]
    A, b, S, W, _, _ = (t.numpy() for t in _problem(refs, "sweep"))
    x, x_ref = got["sweep/x"], refs["sweep/x"]
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x),
                               np.einsum("bij,bj->bi", A, x_ref), atol=0.05)
    np.testing.assert_allclose(_objective(A, b, S, W, x),
                               _objective(A, b, S, W, x_ref), **OBJECTIVE)
    local = np.abs(np.einsum("bij,bj->bi", A, x) - b).max(-1).mean()
    np.testing.assert_allclose(got["sweep/global_err"], local, rtol=1e-3)
    np.testing.assert_allclose(got["sweep/global_kkt"], got["sweep/kkt"].max(),
                               rtol=0)
    assert got["sweep/global_kkt"] <= refs["sweep/global_kkt"] * 5 + 1e-3


def test_pod_mesh_sweep_equals_the_data_mesh_sweep(ranks):
    got = ranks[0]["two"]
    np.testing.assert_array_equal(got["pod/x"], got["sweep/x"])
    np.testing.assert_array_equal(got["pod/global_kkt"], got["sweep/global_kkt"])
    np.testing.assert_array_equal(got["pod/global_err"], got["sweep/global_err"])


def test_kernel_plain_version_per_shard_matches_the_trace(ranks, refs):
    got = ranks[0]["two"]
    A, b, S, W, _, _ = (t.numpy() for t in _problem(refs, "kernel"))
    np.testing.assert_allclose(_objective(A, b, S, W, got["kernel/x"]),
                               _objective(A, b, S, W, refs["kernel/x"]),
                               **OBJECTIVE)
    assert got["kernel/kkt"].max() < KKT_GATE


def _gates(got: dict, ref_final: dict):
    pos = np.abs(got["sim"]["robot"]["base"]["position"]
                 - ref_final["sim"]["robot"]["base"]["position"]).max()
    q = np.abs(got["sim"]["robot"]["q"] - ref_final["sim"]["robot"]["q"]).max()
    return pos, q


def test_sharded_rollout_matches_jax(ranks, refs):
    got = ranks[0]["two"]
    ref = convert.unflatten(refs, "rollout/final/")
    pos, q = _gates({"sim": got["rollout/final"]}, {"sim": ref})
    assert pos < POS_GATE and q < Q_GATE, (pos, q)
    assert np.isfinite(got["rollout/err"]) and np.isfinite(got["rollout/kkt"])
    np.testing.assert_allclose(got["rollout/err"], refs["rollout/err"],
                               atol=POS_GATE)


def test_sharded_locomotion_rollout_matches_jax(ranks, refs):
    got = ranks[0]["two"]
    pos, q = _gates(got["loco/final"], convert.unflatten(refs, "loco/final/"))
    assert pos < POS_GATE and q < Q_GATE, (pos, q)
    assert np.isfinite(got["loco/kkt"])
    assert got["loco/upright"] == refs["loco/upright"] == 1.0


# --------------------------------------------------------------------------
# two ranks against one
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["sweep/x", "sweep/global_kkt", "kernel/x",
                                 "kernel/kkt", "rollout/kkt", "loco/kkt",
                                 "loco/upright"])
def test_two_ranks_equal_one_rank(ranks, key):
    np.testing.assert_array_equal(ranks[0]["two"][key], ranks[0]["one"][key])


@pytest.mark.parametrize("path", ["rollout/final", "loco/final"])
def test_two_rank_rollouts_equal_one_rank(ranks, path):
    two, one = _flatten(ranks[0]["two"][path]), _flatten(ranks[0]["one"][path])
    assert set(two) == set(one)
    for k, v in two.items():
        np.testing.assert_array_equal(v, one[k], err_msg=k)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# --------------------------------------------------------------------------
# the measurements (keys and sanity only: no timing gate)
# --------------------------------------------------------------------------


def test_measure_scaling(ranks):
    for res in ranks:
        sc = res["scaling"]
        assert set(sc) == {1, 2}
        assert sc[1]["efficiency"] == 1.0
        for n, r in sc.items():
            assert set(r) == {"devices", "solves_per_s", "efficiency",
                              "max_kkt", "mean_wrench_err"}
            assert r["devices"] == n and r["solves_per_s"] > 0
            assert np.isfinite(r["max_kkt"])
    assert ranks[0]["scaling"] == ranks[1]["scaling"]  # rank 0's figures


def test_measure_sharding_overhead(ranks):
    for res in ranks:
        ov = res["overhead"]
        assert set(ov) == {"devices", "rate_unsharded", "rate_sharded",
                           "efficiency", "max_kkt", "mean_wrench_err"}
        assert ov["devices"] == WORLD and ov["efficiency"] > 0
        assert np.isfinite(ov["max_kkt"])
    assert ranks[0]["overhead"]["rate_unsharded"] == \
        ranks[1]["overhead"]["rate_unsharded"]


@pytest.mark.slow
def test_references_match_live_jax(refs):
    """The committed JAX outputs are what the JAX package computes now."""
    live = make_refs.parallel_references()
    assert set(live) == set(refs)
    for k, v in live.items():
        np.testing.assert_array_equal(np.asarray(v), refs[k], err_msg=k)
