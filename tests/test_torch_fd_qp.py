"""The port's plain force-distribution QP (``solve_fd_qp_plain``, the CPU
version of the CUDA kernel) and the kernel's recorded answers vs the JAX
package's kernel trace (``qp_pallas.solve_fd_qp_emulated``) and its
generic XLA IPM (``jax.vmap(qp.solve_qp)``).

Inputs: the stance classes of ``test_qp_pallas._stance_problems`` (full,
3-leg and 2-leg stances and the friction-cone-infeasible tail), seeded
random positive-definite QPs, and the QPs that the GPU smoke run's gates
single out. The kernel itself runs only on the GPU (the smoke run holds
it against this plain version there); what it returned on those QPs is
recorded in ``tests/data/torch_port_chip_qps.npz``: the QPs as
``python3 chip_smoke.py --ticks 100 --dump`` wrote them on an H100, the
answers as the kernel now gives them (``scripts/rerecord_chip_qps.py``
re-solves the recorded QPs after a kernel change), and held against the
JAX solvers here. The tests marked ``cuda`` run the kernel itself on the
committed problems and skip without a card; on one (the suite's conftest
needs JAX, which the card's machine lacks):

    python3 -m pytest --noconftest -m cuda tests/test_torch_fd_qp.py

The problems and the JAX solvers' answers are the committed ``fd_qp/``
section of ``tests/data/torch_port_fd_qp_refs.npz``
(``scripts/make_torch_port_references.py --file fd_qp``); ``-m slow``
recomputes them live and repeats every check.

Gates, the same as ``tests/test_qp_pallas.py``: relative objective gap
< 1e-4 on the stance classes and < 1e-5 on the random QPs; honest KKT
< 5e-3 and < 1e-4; Dx - d >= -1e-3. Both sides run a fixed-iteration
float32 IPM with a polish, so they agree in objective to float32 scale
but not bitwise (the W = 1e-4 valley leaves the force itself loose).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch.control import force_distribution as tfd
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel
from quadruped_locomotion_tpu_torch.utils.cuda_build import ptxas_report
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

ITERS = make_refs.FD_ITERS
REFS = Path(make_refs.FD_QP_OUT)
CHIP_QPS = Path(make_refs.CHIP_QPS)
N_STANCE = 6


def _unpack(refs: dict) -> tuple[dict, dict]:
    """(problems, JAX answers) from the ``fd_qp/`` section's keys."""
    p = {k[len("problems/"):]: v for k, v in refs.items()
         if k.startswith("problems/") and not k.startswith("problems/rows/")}
    p["rows"] = {k[len("problems/rows/"):]: slice(*map(int, v))
                 for k, v in refs.items() if k.startswith("problems/rows/")}
    jax_out = dict(emulated=refs["emulated/x"], emulated_kkt=refs["emulated/kkt"],
                   xla=refs["xla/x"])
    jax_out["ensemble"] = {rows: (refs[f"ensemble/{rows}/kkt"],
                                  refs[f"ensemble/{rows}/x"])
                           for rows in make_refs.FD_ENSEMBLE_ROWS}
    return p, jax_out


def _solutions(problems, jax_out):
    plain = fd_qp_kernel.solve_fd_qp_plain(
        *(torch.from_numpy(problems[k]) for k in "GgDd"), iters=ITERS)
    return dict(jax_out, plain=[t.numpy() for t in plain])


@pytest.fixture(scope="module")
def chip():
    with np.load(CHIP_QPS) as f:
        return dict(f)


@pytest.fixture(scope="module")
def committed():
    with np.load(REFS) as f:
        return _unpack({k[len("fd_qp/"):]: f[k] for k in f.files})


@pytest.fixture(scope="module")
def problems(committed):
    """(G, g, D, d) float32 numpy over every row, A/S/b/W of the stance
    rows, and ``rows``: the slices of the row groups (stance, random,
    chip_violators, rollout_worst, articulated_worst, sweep_worst)."""
    return committed[0]


@pytest.fixture(scope="module")
def solutions(committed):
    """The committed JAX answers and one plain call on every row."""
    return _solutions(*committed)


def _objective(p, x, rows):
    """Stance rows: the weighted least-squares objective of the reference
    test; other rows: ½xᵀGx + gᵀx (float64). ``x`` holds the rows of
    ``rows`` only or every row."""
    sl = p["rows"][rows]
    x = x[sl] if len(x) == len(p["G"]) else x
    x = x.astype(np.float64)
    if rows == "stance":
        r = np.einsum("bij,bj->bi", p["A"], x) - p["b"]
        return (np.einsum("bi,bi->b", r * p["S"], r)
                + np.einsum("bi,bi->b", x * p["W"], x))
    G, g = p["G"][sl].astype(np.float64), p["g"][sl]
    return (0.5 * np.einsum("bi,bij,bj->b", x, G, x)
            + np.einsum("bi,bi->b", g, x))


def _min_slack(p, x, rows):
    """min_k (Dx − d)_k per instance of ``rows``."""
    sl = p["rows"][rows]
    x = x[sl] if len(x) == len(p["G"]) else x
    return (np.einsum("bij,bj->bi", p["D"][sl], x) - p["d"][sl]).min(-1)


def _rel_gap(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


GATES = {"stance": (1e-4, 5e-3), "random": (1e-5, 1e-4)}
CHIP_KEYS = {"rollout_worst": "worst", "articulated_worst": "art_worst",
             "sweep_worst": "sweep_worst",
             "rollout25_worst": "rollout25_worst"}
# Worst QPs on which the unperturbed kernel trace converges (KKT < 1e-6);
# on the others it fails (KKT > 1).
TRACE_CONVERGES = {"rollout25_worst"}
# The (rows, solver) cases whose answer on the committed recording misses
# the unperturbed kernel trace's window (PERF.md §6 lists the readings):
# held against the trace's ulp ensemble instead. Every other case is held
# to the unperturbed run.
ENSEMBLE_CASES = {("rollout_worst", "kernel"), ("rollout_worst", "plain"),
                  ("sweep_worst", "plain")}


def check_plain_objective(problems, solutions, rows, reference):
    x = solutions["plain"][0]
    obj = _objective(problems, x, rows)
    ref = _objective(problems, solutions[reference], rows)
    rel = _rel_gap(obj, ref)
    assert rel.max() < GATES[rows][0], f"objective gap {rel}"


def check_plain_kkt_and_feasibility(problems, solutions, rows):
    x, s, z, kkt = solutions["plain"]
    sl = problems["rows"][rows]
    assert np.isfinite(x).all() and np.isfinite(kkt).all()
    assert kkt[sl].max() < GATES[rows][1], f"kkt {kkt[sl]}"
    slack = np.einsum("bij,bj->bi", problems["D"], x) - problems["d"]
    assert slack[sl].min() > -1e-3, f"constraint violation {slack[sl].min()}"
    # returned s is the slack of x floored at 0
    np.testing.assert_allclose(s, np.maximum(slack, 0.0), atol=1e-4, rtol=1e-5)


def check_violation_envelope(problems, solutions, chip, solver):
    rows = "chip_violators"
    emu = _min_slack(problems, solutions["emulated"], rows)
    xla = _min_slack(problems, solutions["xla"], rows)
    assert emu.min() < -1e-3 and xla.min() < -1e-3, (emu, xla)
    x = (chip["violators_x_kernel"] if solver == "kernel"
         else solutions["plain"][0])
    worst = _min_slack(problems, x, rows).min()
    assert worst >= min(emu.min(), xla.min()) - 1e-3, (worst, emu, xla)
    gap = _rel_gap(_objective(problems, x, rows),
                   _objective(problems, solutions["emulated"], rows))
    assert gap.max() < 1e-4, gap


def check_worst_qp(problems, solutions, chip, solver, rows):
    """A rollout's worst-KKT QP, where the JAX kernel trace itself fails
    (KKT > 1; or, for the rows of ``TRACE_CONVERGES``, where it converges).
    The kernel's recorded result (or the plain version's) must reach the
    unperturbed trace's KKT within a factor of 2 and its objective within
    1e-2 (relative).

    Where the trace ends on such a QP is chaotic: with each input entry
    moved by at most one ulp, its KKT ranges over ~0.006-5.6 on the
    massless one and ~1e-7-4.3 on the articulated one, so a port that sums
    in another order may land elsewhere. For the ``ENSEMBLE_CASES`` the
    same window is taken against each member of the trace's 64-member ulp
    ensemble (member 0 is the unperturbed run), and a member that matches
    must itself lie within a factor of 3 of member 0's KKT."""
    sl = problems["rows"][rows]
    k0 = solutions["emulated_kkt"][sl][0]
    assert k0 < 1e-6 if rows in TRACE_CONVERGES else k0 > 1.0
    if solver == "kernel":
        key = CHIP_KEYS[rows]
        x, k = chip[f"{key}_x"], float(chip[f"{key}_kkt"])
    else:
        x, k = solutions["plain"][0][sl][0], solutions["plain"][3][sl][0]
    ens_kkt, ens_x = solutions["ensemble"].get(  # member 0 where none
        rows, (solutions["emulated_kkt"][sl][:1], solutions["emulated"][sl][:1]))
    assert ens_kkt[0] == k0
    np.testing.assert_array_equal(ens_x[0], solutions["emulated"][sl][0])
    if (rows, solver) not in ENSEMBLE_CASES:
        ens_kkt, ens_x = ens_kkt[:1], ens_x[:1]
    obj = _objective(problems, x[None], rows)
    gap = np.array([_rel_gap(obj, _objective(problems, e[None], rows))[0]
                    for e in ens_x])
    match = ((0.5 * ens_kkt < k) & (k < 2.0 * ens_kkt) & (gap < 1e-2)
             & (k0 / 3.0 < ens_kkt) & (ens_kkt < 3.0 * k0))
    assert match.any(), (k, k0, ens_kkt, gap)


@pytest.mark.parametrize("rows", ["stance", "random"])
@pytest.mark.parametrize("reference", ["emulated", "xla"])
def test_plain_matches_reference_objective(problems, solutions, rows,
                                           reference):
    check_plain_objective(problems, solutions, rows, reference)


@pytest.mark.parametrize("rows", ["stance", "random"])
def test_plain_kkt_and_feasibility(problems, solutions, rows):
    check_plain_kkt_and_feasibility(problems, solutions, rows)


@pytest.mark.parametrize("solver", ["kernel", "plain"])
def test_violation_within_reference_envelope(problems, solutions, chip,
                                             solver):
    """On the instances where the CUDA kernel or the plain version on the
    card ended more than 1e-3 outside Dx ≥ d in the smoke run's B = 4096
    check, the JAX kernel trace and the XLA IPM end outside too: the
    −1e-3 gate is one the reference does not meet on them (the forces
    run to hundreds of N, so 1e-3 N is float32 rounding of the cone
    rows). The kernel's recorded worst violation, and the plain
    version's here, stay within 1e-3 of the references' worst, and their
    objectives within 1e-4 (relative) of the kernel trace's."""
    check_violation_envelope(problems, solutions, chip, solver)


@pytest.mark.parametrize("solver", ["kernel", "plain"])
def test_rollout_worst_qp_matches_reference(problems, solutions, chip,
                                            solver):
    """The QP with the largest KKT residual of the smoke run's 4096 x
    100-tick massless rollout: the JAX kernel trace does not solve it in
    15 iterations either (KKT > 1), and the kernel's recorded result and
    the plain version end where the trace ends (``check_worst_qp``): the
    failure is the algorithm's, not the port's."""
    check_worst_qp(problems, solutions, chip, solver, "rollout_worst")


@pytest.mark.parametrize("solver", ["kernel", "plain"])
def test_articulated_worst_qp_matches_reference(problems, solutions, chip,
                                                solver):
    """The same for the QP with the largest KKT residual of the smoke
    run's 4096 x 50-tick articulated rollout."""
    check_worst_qp(problems, solutions, chip, solver, "articulated_worst")


@pytest.mark.parametrize("solver", ["kernel", "plain"])
def test_sweep_worst_qp_matches_reference(problems, solutions, chip, solver):
    """The same for the QP with the largest KKT residual of the smoke
    run's 4096 x 100-tick config-5 sweep (per-scenario terrain, trot/pace
    mix; tick 44, scenario 24): it ends ~75 N outside the friction cone
    under the JAX kernel trace too (KKT 7.23). The kernel meets the
    unperturbed trace (6.96). The plain version follows the trace's
    operations in the trace's order but rounds rsqrt as PyTorch does, and
    the trace's first rsqrt (the start point's factor, column 0) already
    rounds differently: it ends at 11.53, where a member of the trace's
    ulp ensemble ends (11.45, objective within 1.7e-3)."""
    check_worst_qp(problems, solutions, chip, solver, "sweep_worst")


@pytest.mark.parametrize("solver", ["plain"])
def test_rollout25_worst_qp_matches_reference(problems, solutions, chip,
                                              solver):
    """The worst QP of the smoke run's massless rollout at its default
    depth, 4096 x 25 ticks (tick 1, substep 7, scenario 2818). The
    unperturbed kernel trace converges on it (KKT 1.2e-7), and so does the
    plain version (2.0e-7)."""
    check_worst_qp(problems, solutions, chip, solver, "rollout25_worst")


def check_rollout25_kernel_in_ensemble(problems, solutions, chip):
    rows = "rollout25_worst"
    ens_kkt, ens_x = solutions["ensemble"][rows]
    assert ens_kkt[0] < 1e-6 and (ens_kkt > 1e-3).mean() > 1 / 3
    k = float(chip["rollout25_worst_kkt"])
    obj = _objective(problems, chip["rollout25_worst_x"][None], rows)
    gap = np.array([_rel_gap(obj, _objective(problems, e[None], rows))[0]
                    for e in ens_x])
    near = (0.5 * ens_kkt < k) & (k < 2.0 * ens_kkt) & (gap < 1e-2)
    # the fault: outside the unperturbed trace's window
    assert not near[0] and k > 1e-3, (k, ens_kkt[0], gap[0])
    # where it ends instead: among the members that fail to converge
    assert near.sum() >= 8 and (ens_kkt[near] > 1e-3).all(), (k, ens_kkt, gap)


def test_rollout25_worst_kernel_ends_in_the_reference_ensemble(problems,
                                                               solutions,
                                                               chip):
    """The CUDA kernel's recorded answer on that QP is the open fault of
    ROADMAP.md §1 item 2: it misses ``check_worst_qp``'s window of the
    unperturbed trace, which converges (1.2e-7), and ends at KKT 0.247
    with an objective 2.1 % above the optimum. The reference is chaotic
    on this QP: with each input entry moved by at most one ulp, a third or
    more of the trace's ulp ensemble fails to converge, and 8 or more of
    those members end within ``check_worst_qp``'s window (KKT within x2,
    objective within 1e-2) of the kernel's answer. This test pins both
    readings: once the kernel converges here it fails, and the kernel
    case belongs in ``test_rollout25_worst_qp_matches_reference``."""
    check_rollout25_kernel_in_ensemble(problems, solutions, chip)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kernel(problems, cuda_device):
    """The kernel's answers on every committed problem row, from one
    launch: keyed as the recording keys them, and under ``all`` the
    (x, s, z, kkt) of every row."""
    G, g, D, d = (torch.from_numpy(problems[k]).to(cuda_device)
                  for k in "GgDd")
    x, s, z, kkt = (t.cpu().numpy() for t in fd_qp_kernel.solve_fd_qp(
        G, g, D, d, iters=ITERS))
    live = {"violators_x_kernel": x[problems["rows"]["chip_violators"]],
            "all": [x, s, z, kkt]}
    for rows, key in CHIP_KEYS.items():
        sl = problems["rows"][rows]
        live[f"{key}_x"], live[f"{key}_kkt"] = x[sl][0], kkt[sl][0]
    return live


@pytest.mark.cuda
def test_kernel_on_the_card_returns_the_recorded_answers(kernel, chip):
    """Bit for bit: what the tests above hold against the JAX solvers is
    what the kernel returns (an instance's answer does not depend on B or
    on its position, so one launch over the committed rows reproduces the
    answers recorded inside the rollouts)."""
    for key in ["violators_x_kernel"] + [f"{k}_{v}" for k in CHIP_KEYS.values()
                                         for v in ("x", "kkt")]:
        np.testing.assert_array_equal(kernel[key], chip[key], err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["stance", "random"])
def test_kernel_on_the_card_meets_the_plain_gates(problems, solutions, kernel,
                                                  rows):
    """The gates the plain version meets on the stance and random rows."""
    as_plain = dict(solutions, plain=kernel["all"])
    for reference in ("emulated", "xla"):
        check_plain_objective(problems, as_plain, rows, reference)
    check_plain_kkt_and_feasibility(problems, as_plain, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["chip_violators", *CHIP_KEYS])
def test_kernel_on_the_card_meets_the_recorded_gates(problems, solutions,
                                                     kernel, rows):
    """The gates the recorded kernel answers are held to above, on the
    kernel's answers now."""
    if rows == "chip_violators":
        check_violation_envelope(problems, solutions, kernel, "kernel")
    elif rows == "rollout25_worst":
        check_rollout25_kernel_in_ensemble(problems, solutions, kernel)
    else:
        check_worst_qp(problems, solutions, kernel, "kernel", rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["rollout25_worst", "sweep_worst"])
def test_kernel_answer_is_the_same_in_every_batch_position_and_half(
        problems, cuda_device, rows):
    """One QP at positions 0, 1, 2 and B - 1 of batches of 1, 2, 3 and 4097
    (the other instances the committed rows in turn): the same bits every
    time, in either half of a warp, in the ragged last warp and alone."""
    import chip_smoke

    G, g, D, d = (torch.from_numpy(problems[k]).to(cuda_device)
                  for k in "GgDd")
    n = chip_smoke.check_packing(G, g, D, d, problems["rows"][rows].start)
    assert n == len(chip_smoke.PACKING_CASES)


@pytest.mark.cuda
def test_kernel_launch_geometry_on_the_card(problems, cuda_device):
    """No spills, 4 blocks of 8 instances resident an SM (32 instances),
    every half-warp of the running warps busy at an even B and half of
    them at B = 1, and ``qp.kernel_instances`` counting B a launch."""
    build = fd_qp_kernel.KERNEL.build()
    report = ptxas_report(build.log)
    assert report["spill_store_bytes"] == report["spill_load_bytes"] == 0
    assert build.instances_per_block == 8 and build.resident_blocks_per_sm >= 4
    assert fd_qp_kernel.KERNEL.geometry(16384)["slot_share"] == 1.0
    assert fd_qp_kernel.KERNEL.geometry(1)["slot_share"] == 0.5
    G, g, D, d = (torch.from_numpy(problems[k][:3]).to(cuda_device)
                  for k in "GgDd")
    before = counters["qp.kernel_launches"], counters["qp.kernel_instances"]
    fd_qp_kernel.solve_fd_qp(G, g, D, d)
    assert (counters["qp.kernel_launches"] - before[0],
            counters["qp.kernel_instances"] - before[1]) == (1, 3)


def test_committed_problems_hold_the_recorded_qps(problems, chip):
    """The committed references were made from the recorded QPs as they
    are now (regenerate them after refreshing the recording)."""
    for rows, key in make_refs.FD_CHIP_ROWS.items():
        sl = problems["rows"][rows]
        for k in "GgDd":
            rec = chip[f"{key}_{k}"]
            rec = rec if rows == "chip_violators" else rec[None]
            np.testing.assert_array_equal(problems[k][sl], rec)


def test_auto_backend_on_cpu_runs_plain_and_counts_no_launch(problems):
    counters["qp.kernel_launches"] = 0
    G, g, D, d = (torch.from_numpy(problems[k][:N_STANCE]) for k in "GgDd")
    sol = tfd.solve_formed_qp_batched(G, g, D, d, iters=ITERS, backend="auto")
    plain = fd_qp_kernel.solve_fd_qp_plain(G, g, D, d, iters=ITERS)
    np.testing.assert_array_equal(sol.x.numpy(), plain[0].numpy())
    assert sol.y.shape == (N_STANCE, 0)
    assert (sol.iterations == ITERS).all()
    assert counters["qp.kernel_launches"] == 0


@pytest.mark.parametrize("entry", ["weighted_ls", "formed"])
def test_kernel_backend_raises_on_cpu(problems, entry):
    """Both QP entries resolve ``backend`` alike: "kernel" needs CUDA
    tensors, and a name that is not a backend raises."""
    G, g, D, d = (torch.from_numpy(problems[k][:2]) for k in "GgDd")
    if entry == "formed":
        solve = lambda backend: tfd.solve_formed_qp_batched(  # noqa: E731
            G, g, D, d, backend=backend)
    else:
        A, S, b, W = (torch.zeros((2, *shape)) for shape in
                      ((6, 12), (6,), (6,), (12,)))
        solve = lambda backend: tfd.solve_fd_qp_batched(  # noqa: E731
            A, b, S, W, D, d, backend=backend)
    with pytest.raises(ValueError, match="needs CUDA"):
        solve("kernel")
    with pytest.raises(ValueError, match="unknown QP backend"):
        solve("pallas_interpret")


PTXAS = (
    "ptxas info    : Compiling entry function 'fd_qp_ipm_kernel' for "
    "'sm_90a'\nptxas info    : Function properties for fd_qp_ipm_kernel\n"
    "    {stack} bytes stack frame, {st} bytes spill stores, {ld} bytes "
    "spill loads\nptxas info    : Used {regs} registers, 21760 bytes smem, "
    "400 bytes cmem[0]\n")


@pytest.mark.parametrize("case", ["clean", "spills", "missing"])
def test_ptxas_report(case):
    """The smoke run's no-spill gate reads ``-Xptxas -v`` output through
    ``ptxas_report``; a log without the report raises."""
    if case == "missing":
        with pytest.raises(ValueError, match="no ptxas"):
            ptxas_report("nvcc: done\n")
        return
    spills = case == "spills"
    log = PTXAS.format(stack=14736 if spills else 0, st=64048 if spills else 0,
                       ld=98024 if spills else 0, regs=32 if spills else 88)
    rep = ptxas_report(log)
    assert rep == dict(registers=32 if spills else 88, smem_bytes=21760,
                       stack_bytes=14736 if spills else 0,
                       spill_store_bytes=64048 if spills else 0,
                       spill_load_bytes=98024 if spills else 0)


def test_roofline_counts():
    """The bound's inputs: ~1.69e5 flop per instance (the algorithm's
    work, with D·diag(z/s) formed once per iteration and the Schur
    product at one multiply-add per term: ~8.9e3 flop per IPM iteration)
    and 1,876 bytes per instance."""
    flops = fd_qp_kernel.fd_qp_flops
    per_iter = flops(ITERS + 1) - flops(ITERS)
    assert per_iter == flops(1) - flops(0)
    assert 8.5e3 < per_iter < 9.5e3
    assert 1.6e5 < flops(ITERS) < 1.8e5
    assert fd_qp_kernel.fd_qp_bytes(1) == 4 * (144 + 12 + 240 + 20 + 12 + 20
                                               + 20 + 1)


@pytest.mark.slow
def test_references_match_live_jax(problems, chip):
    """Recomputes the problems and the JAX answers (the eager kernel trace
    and an XLA:CPU compile) and repeats every check against them."""
    live = {k: np.asarray(v) for k, v in make_refs.fd_qp_references().items()}
    p, jax_out = _unpack(live)
    assert p["rows"] == problems["rows"]
    for k in ("G", "g", "D", "d", "A", "S", "b", "W"):
        np.testing.assert_allclose(p[k], problems[k], rtol=1e-6, atol=1e-6)
    sol = _solutions(p, jax_out)
    for rows in GATES:
        for reference in ("emulated", "xla"):
            check_plain_objective(p, sol, rows, reference)
        check_plain_kkt_and_feasibility(p, sol, rows)
    for solver in ("kernel", "plain"):
        check_violation_envelope(p, sol, chip, solver)
        for rows in CHIP_KEYS:
            check_worst_qp(p, sol, chip, solver, rows)
