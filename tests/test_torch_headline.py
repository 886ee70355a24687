"""The port's QP headline path on the CPU, against the JAX package:
``headline.build_batch`` vs ``bench.build_batch``, the weighted
least-squares QP wrapper (``fd_qp_kernel.solve_weighted_ls_fd_qp``, plain
version on CPU tensors) vs the JAX kernel trace
(``qp_pallas.solve_weighted_ls_fd_qp(emulate=True)``) on one 1024-instance
tile, ``tail_proof`` and the quality block vs ``bench.py``'s, and, on
``tests/test_balance.py``'s load-factor batch, the batched double solve
and ``distribute`` vs the JAX ``distribute`` (the reference that test
holds the JAX batched solve against).

The JAX outputs are the committed ``headline/`` section of
``tests/data/torch_port_slice2_refs.npz``
(``scripts/make_torch_port_references.py``); ``-m slow`` recomputes them
live and repeats every check. ``bench.tail_proof`` runs live (numpy and
scipy). The test may import ``bench`` (which imports JAX); the port may
not.

Tolerances: problem data agree to float32 rounding of the VMC wrench
(b within 1e-3 N of ~1e3 N, everything else exactly). Solutions are
compared by objective (bench.py's gates: median relative gap ≤ 1e-4,
p99 ≤ 1e-3) and by realised wrench, because the W = 1e-4 regulariser
leaves a flat valley in which two float32 solvers land up to ~1 N apart
on equal objectives (test_balance.py's own 0.5 N wrench / 2 N force
gates).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from quadruped_locomotion_tpu_torch import headline
from quadruped_locomotion_tpu_torch.control import force_distribution as tfd
from quadruped_locomotion_tpu_torch.control.vmc import compute_virtual_wrench
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
from quadruped_locomotion_tpu_torch.rollout import simulator as tsim
from quadruped_locomotion_tpu_torch.types import (
    BaseTarget, CfdParams, RobotModel, VmcGains,
)
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice2_refs.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

TILE = make_refs.TILE
FIELDS = "AbSWDd"
LF = make_refs.LOAD_FACTORS
B_LF = make_refs.B_LF


@pytest.fixture(scope="module")
def refs():
    with np.load(REFS) as f:
        return {k[len("headline/"):]: f[k] for k in f.files
                if k.startswith("headline/")}


@pytest.fixture(scope="module")
def port_batch():
    return {k: t.numpy() for k, t in zip(FIELDS, headline.build_batch(TILE, "cpu"))}


def _tile(refs):
    return {k: refs[f"tile/{k}"] for k in FIELDS}


def _solve_plain(refs):
    """The reference tile through the port's wrapper (plain version on the
    CPU): no kernel launch is counted."""
    p = _tile(refs)
    counters["qp.kernel_launches"] = counters["qp.wls_launches"] = 0
    out = fk.solve_weighted_ls_fd_qp(
        *(torch.from_numpy(p[k].copy()) for k in "ASbWDd"), iters=15)
    assert counters["qp.kernel_launches"] == counters["qp.wls_launches"] == 0
    return out


@pytest.fixture(scope="module")
def solved(refs):
    return _solve_plain(refs)


def _objective64(p, x):
    x = np.asarray(x, np.float64)
    r = np.einsum("bij,bj->bi", p["A"], x) - p["b"]
    return (r * p["S"] * r).sum(-1) + (x * p["W"] * x).sum(-1)


def check_build_batch(refs, port_batch, field):
    ref, port = refs[f"tile/{field}"], port_batch[field]
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.float32
    tol = 1e-3 if field == "b" else 1e-6  # b: float32 VMC rounding
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


def check_wrapper_vs_trace(refs, solved):
    p = _tile(refs)
    x, kkt = solved[0].numpy(), solved[3].numpy()
    ref = _objective64(p, refs["tile/x_emulated"])
    gap = np.abs(_objective64(p, x) - ref) / (1 + np.abs(ref))
    assert np.median(gap) <= 1e-4 and np.percentile(gap, 99) <= 1e-3, gap
    assert np.isfinite(kkt).all() and np.percentile(kkt, 99) <= 1e-4
    min_slack = lambda x: (np.einsum("bij,bj->bi", p["D"], x)  # noqa: E731
                           - p["d"]).min(-1)
    plain, trace = min_slack(x), min_slack(refs["tile/x_emulated"])
    assert trace.min() < -1e-3  # the reference leaves violations too
    assert np.percentile(plain, 1) >= -1e-3 and plain.min() >= -5e-2


def _balance_torch(refs):
    return {k: torch.from_numpy(refs[f"balance/{k}"].copy()) for k in FIELDS}


def check_load_factors(refs, backend):
    p = _balance_torch(refs)
    lf = torch.from_numpy(LF).expand(B_LF, 4)
    support = torch.ones((B_LF, 4), dtype=torch.bool)
    counters["qp.kernel_launches"] = 0
    sol = tfd.solve_fd_qp_batched(p["A"], p["b"], p["S"], p["W"], p["D"], p["d"],
                                  iters=25, backend=backend, load_factors=lf,
                                  support=support)
    first = tfd.solve_fd_qp_batched(p["A"], p["b"], p["S"], p["W"], p["D"],
                                    p["d"], iters=25, backend=backend)
    assert counters["qp.kernel_launches"] == 0
    A64 = refs["balance/A"].astype(np.float64)
    x = sol.x.numpy()
    x_ref = refs["balance/grf_distribute"].reshape(B_LF, 12)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A64, x),
                               np.einsum("bij,bj->bi", A64, x_ref), atol=0.5)
    np.testing.assert_allclose(x, x_ref, atol=2.0)
    np.testing.assert_array_equal(x[:, 6:9], (first.x[:, 6:9] * 0.5).numpy())


def _port_balance_state():
    model = RobotModel.simpledog("cpu")
    sim = tsim.default_stance_state(model, height=0.4, batch=(B_LF,))
    target = BaseTarget.from_base(sim.robot.base)
    base = sim.robot.base.replace(position=sim.robot.base.position
                                  + torch.from_numpy(make_refs.balance_noise()))
    state = sim.robot.replace(base=base)
    vf, vt = compute_virtual_wrench(model, VmcGains.gazebo_defaults("cpu"),
                                    state, target)
    return model, CfdParams.defaults("cpu"), state, vf, vt


def check_distribute(refs):
    model, cfd, state, vf, vt = _port_balance_state()
    single = tfd.distribute(model, cfd, state, vf, vt, iters=25)
    res = tfd.distribute(model, cfd, state, vf, vt, iters=25,
                         load_factors=torch.from_numpy(LF).expand(B_LF, 4))
    np.testing.assert_allclose(res.ground_reaction.numpy(),
                               refs["balance/grf_distribute"], atol=2.0)
    np.testing.assert_allclose(res.virtual_wrench_realized.numpy(),
                               refs["balance/wrench_distribute"], atol=0.5)
    np.testing.assert_allclose(res.ground_reaction[:, 2].numpy(),
                               0.5 * single.ground_reaction[:, 2].numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("field", list(FIELDS))
def test_build_batch_matches_bench(refs, port_batch, field):
    check_build_batch(refs, port_batch, field)


def test_weighted_ls_wrapper_matches_kernel_trace(refs, solved):
    """Objective gap median ≤ 1e-4 and p99 ≤ 1e-3 against the JAX kernel
    trace (bench.py's backend-agreement gate; observed 4.7e-6 / 2.1e-4),
    KKT p99 ≤ 1e-4 (bench.py's quality gate), finite, and Dx − d ≥ −1e-3
    on 99 % of the instances. A few instances end mN outside the cone
    under this float32 algorithm, the JAX kernel trace included (3 of
    this tile below −1e-3, worst −2.1e-3; the plain version 5, worst
    −3.6e-2 at forces of hundreds of N): the worst is held to 5e-2."""
    check_wrapper_vs_trace(refs, solved)


def test_tail_proof_matches_bench(refs, solved):
    """The port's copy of tail_proof returns bench.tail_proof's result on
    the same numpy inputs."""
    p = _tile(refs)
    x = solved[0].numpy()
    werr = np.abs(np.einsum("bij,bj->bi", p["A"], x) - p["b"]).max(-1)
    args = [p[k] for k in FIELDS] + [x, werr]
    want = bench.tail_proof(*args, max_oracle=8)
    got = headline.tail_proof(*args, max_oracle=8)
    assert got == want
    assert want[0] > 0.1 and want[3]  # a real tail, proven constraint-bound


def test_quality_block_matches_bench_formulas(refs, solved):
    """KKT percentiles and the wrench error as bench.py computes them
    (jnp.einsum at HIGHEST precision)."""
    p = _tile(refs)
    t = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    x, kkt = solved[0], solved[3]
    q = headline.quality(*(t[k] for k in FIELDS), x, kkt)
    realized = jnp.einsum("bij,bj->bi", p["A"], x.numpy(),
                          precision=jax.lax.Precision.HIGHEST)
    werr = np.asarray(jnp.max(jnp.abs(realized - p["b"]), axis=-1))
    np.testing.assert_allclose(q["wrench_err_p50"], np.median(werr), rtol=1e-5)
    np.testing.assert_allclose(q["wrench_err_p99"], np.percentile(werr, 99),
                               rtol=1e-5)
    np.testing.assert_allclose(q["kkt_p99"], np.percentile(kkt.numpy(), 99),
                               rtol=1e-6)
    assert q["kkt_finite"] and q["tail_proven"]
    assert q["wrench_err_p50"] <= 0.1  # bench.py's median gate


def test_generic_cross_check_on_cpu(refs, solved):
    """bench.py's kernel-vs-generic objective gap, on 64 instances."""
    t = {k: torch.from_numpy(v.copy()) for k, v in _tile(refs).items()}
    gap = headline.generic_gap(*(t[k] for k in FIELDS), solved[0], sub=64)
    assert gap["generic_instances"] == 64
    assert gap["generic_gap_median"] <= 1e-4 and gap["generic_gap_p99"] <= 1e-3


def test_headline_entry_points_need_cuda(monkeypatch):
    with pytest.raises(ValueError, match="times the card"):
        headline.measure(batch=8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        headline.build_batch(8)


def test_roofline_counts_of_the_wrapper():
    """The formation adds ~2.0e3 flop to the kernel's ~1.69e5, and the
    wrapper reads 356 floats per instance (A, S, b, W, D, d) where the
    kernel reads 416 (G, g, D, d)."""
    extra = fk.weighted_ls_fd_qp_flops() - fk.fd_qp_flops()
    assert 1.9e3 < extra < 2.2e3
    assert fk.weighted_ls_fd_qp_bytes(1) == 4 * (356 + 53)
    assert fk.fd_qp_bytes(1) == 4 * (416 + 53)


@pytest.mark.parametrize("backend", ["generic", "plain"])
def test_load_factor_double_solve_matches_jax(refs, backend):
    """The port's batched elimination on the reference's problem data
    (test_balance.py's 4 scenarios, ±2 cm, numpy seed 7): realised wrench
    within 0.5 N and forces within 2 N of the JAX distribute
    (test_balance.py's gates for the JAX batched solve), the pinned leg
    exactly 0.5 × the port's own first solve, no kernel launch on the
    CPU."""
    check_load_factors(refs, backend)


def test_load_factors_need_support(refs):
    p = _balance_torch(refs)
    with pytest.raises(ValueError, match="support"):
        tfd.solve_fd_qp_batched(p["A"], p["b"], p["S"], p["W"], p["D"],
                                p["d"], load_factors=torch.ones(B_LF, 4))
    with pytest.raises(ValueError, match="needs CUDA"):
        tfd.solve_fd_qp_batched(p["A"], p["b"], p["S"], p["W"], p["D"],
                                p["d"], backend="kernel")


@pytest.mark.parametrize("load_factors", [False, True])
def test_distribute_matches_jax(refs, load_factors):
    """The port's distribute on its own build of the same states: with
    load factors, forces within 2 N and realised wrench within 0.5 N of
    the JAX distribute, the pinned leg at 0.5 × the single solve;
    without, the realised wrench matches the requested one within 0.5 N
    (test_balance.py's statics gate)."""
    if load_factors:
        check_distribute(refs)
        return
    model, cfd, state, vf, vt = _port_balance_state()
    single = tfd.distribute(model, cfd, state, vf, vt, iters=25)
    np.testing.assert_allclose(single.virtual_wrench_realized.numpy(),
                               torch.cat([vf, vt], -1).numpy(), atol=0.5)
    assert (single.ground_reaction[..., 2] >= 10.0 - 1e-3).all()


def test_distribute_warm_light_polish():
    """The realtime levers: a warm-started 8-iteration solve with the
    light polish reaches the cold solve's realised wrench."""
    model, cfd, state, vf, vt = _port_balance_state()
    cold = tfd.distribute(model, cfd, state, vf, vt, iters=15)
    sol = cold.qp_solution
    warm = tfd.distribute(model, cfd, state, vf, vt, iters=8,
                          warm=(sol.x, sol.z), polish="light")
    np.testing.assert_allclose(warm.virtual_wrench_realized.numpy(),
                               cold.virtual_wrench_realized.numpy(), atol=0.5)
    assert warm.qp_solution.kkt_error.max() < 1e-3


@pytest.mark.slow
def test_references_match_live_jax(port_batch):
    """Recomputes the JAX references (bench.build_batch, the kernel trace,
    distribute; XLA:CPU compiles) and repeats every check against them."""
    live = {k: np.asarray(v) for k, v in make_refs.headline_references().items()}
    for field in FIELDS:
        check_build_batch(live, port_batch, field)
    check_wrapper_vs_trace(live, _solve_plain(live))
    for backend in ("generic", "plain"):
        check_load_factors(live, backend)
    check_distribute(live)
