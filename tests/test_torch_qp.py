"""The port's generic QP (``quadruped_locomotion_tpu_torch/ops/qp.py``)
against the JAX package's ``ops/qp.py`` on the cases of
``tests/test_qp.py``, plus the error-free transforms its polish relies on.

Inputs are made with numpy seeds (``scripts/make_torch_port_references.py``
holds the generators) and handed to both packages as float32. The JAX
outputs are the committed ``qp/`` section of
``tests/data/torch_port_slice2_refs.npz``; ``-m slow`` recomputes them
live and repeats every check. Both sides run the same fixed-iteration
float32 IPM and polish, so their solutions agree to float32 rounding of
the factorizations: 1e-4 on x for these well-conditioned problems
(observed ~1e-7), and both meet the reference test's own gates against
scipy (2e-3).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch.ops import qp as tqp
from test_qp import scipy_qp

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice2_refs.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

X_TOL = 1e-4  # port vs JAX, same algorithm in float32


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def refs():
    with np.load(REFS) as f:
        return {k[len("qp/"):]: f[k] for k in f.files if k.startswith("qp/")}


@pytest.fixture(scope="module")
def ineq():
    """The port's solutions of the six inequality QPs (one batched call)."""
    G, g, D, d = make_refs.ineq_problems()
    return tqp.solve_qp(*map(_t, (G, g, D, d)), iters=30)


def check_worked_example(refs):
    w = make_refs.worked_example()
    sol = tqp.solve_qp(*(_t(w[k]) for k in "GgDd"), C=_t(w["C"]), c=_t(w["c"]))
    x = sol.x.numpy()
    np.testing.assert_allclose(x, [1.0, 2.0], atol=1e-4)
    G, g = w["G"], w["g"]
    np.testing.assert_allclose(0.5 * x @ G @ x + g @ x, 12.0, atol=1e-3)
    np.testing.assert_allclose(x, refs["worked/x"], atol=X_TOL)
    np.testing.assert_allclose(sol.y.numpy(), refs["worked/y"], atol=1e-3)
    assert sol.x.shape == (2,) and sol.kkt_error.shape == ()


def check_inequality(refs, port, seed):
    G, g, D, d = make_refs.ineq_problems()
    x = port.x.numpy()[seed]
    np.testing.assert_allclose(x, refs["ineq/x"][seed], atol=X_TOL)
    np.testing.assert_allclose(x, scipy_qp(G[seed], g[seed], D[seed], d[seed]),
                               atol=2e-3)
    assert port.iterations[seed] == int(refs["ineq/iterations"][seed])


def check_equality(refs, seed):
    G, g, D, d, C, c = (a[seed] for a in make_refs.eq_problems())
    sol = tqp.solve_qp(*map(_t, (G, g, D, d)), C=_t(C), c=_t(c), iters=30)
    np.testing.assert_allclose(sol.x.numpy(), refs["eq/x"][seed], atol=X_TOL)
    np.testing.assert_allclose(sol.x.numpy(), scipy_qp(G, g, D, d, C, c),
                               atol=2e-3)


def check_warm_light(refs, port):
    """An 8-iteration warm start from each side's own cold solution with
    the light polish."""
    G, g, D, d = make_refs.ineq_problems()
    sol = tqp.solve_qp(*map(_t, (G, g, D, d)), iters=8, warm=(port.x, port.z),
                       polish="light")
    np.testing.assert_allclose(sol.x.numpy(), refs["warm_light/x"], atol=X_TOL)
    assert sol.kkt_error.max() < 1e-4


def test_quadprogpp_worked_example(refs):
    """x = [1, 2], f = 12, as the reference's documented example, and the
    same point as the JAX solver."""
    check_worked_example(refs)


def test_unconstrained_matches_linear_solve():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 5))
    G = A @ A.T + 5 * np.eye(5)
    g = rng.normal(size=5)
    sol = tqp.solve_qp(_t(G), _t(g), _t(np.eye(5)), _t(np.full(5, -1e3)))
    np.testing.assert_allclose(sol.x.numpy(), np.linalg.solve(G, -g), atol=1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_random_inequality_qps(refs, ineq, seed):
    check_inequality(refs, ineq, seed)


@pytest.mark.parametrize("seed", range(3))
def test_random_equality_qps(refs, seed):
    check_equality(refs, seed)


def test_equality_batch_matches_single_solves():
    """Leading batch dims: one batched call gives each instance's answer."""
    G, g, D, d, C, c = make_refs.eq_problems()
    batched = tqp.solve_qp(*map(_t, (G, g, D, d)), C=_t(C), c=_t(c), iters=30)
    for i in range(len(G)):
        one = tqp.solve_qp(*map(_t, (G[i], g[i], D[i], d[i])), C=_t(C[i]),
                           c=_t(c[i]), iters=30)
        np.testing.assert_allclose(batched.x[i].numpy(), one.x.numpy(),
                                   atol=1e-6)


def test_kkt_residuals_small():
    rng = np.random.default_rng(7)
    n, mi = 12, 20
    A = rng.normal(size=(n, n))
    G, g = A @ A.T + n * np.eye(n), rng.normal(size=n)
    D, d = rng.normal(size=(mi, n)), rng.uniform(-1.0, 0.0, size=mi)
    args = tuple(map(_t, (G, g, D, d)))
    sol = tqp.solve_qp(*args, iters=30)
    res = tqp.kkt_residuals(*args, sol)
    assert set(res) == {"stationarity", "primal", "complementarity", "dual"}
    for k, v in res.items():
        assert float(v) < 1e-3, f"{k} residual too large: {float(v)}"


def test_masked_disabled_rows():
    """Zeroed rows with d = -1 do not change the solution."""
    rng = np.random.default_rng(8)
    n = 4
    A = rng.normal(size=(n, n))
    G, g = A @ A.T + n * np.eye(n), rng.normal(size=n)
    sol1 = tqp.solve_qp(_t(G), _t(g), _t(np.eye(n)), _t(np.full(n, -10.0)))
    D2 = np.concatenate([np.eye(n), np.zeros((6, n))])
    d2 = np.concatenate([np.full(n, -10.0), np.full(6, -1.0)])
    sol2 = tqp.solve_qp(_t(G), _t(g), _t(D2), _t(d2))
    np.testing.assert_allclose(sol1.x.numpy(), sol2.x.numpy(), atol=1e-4)


def test_warm_start_light_polish_matches_jax(refs, ineq):
    check_warm_light(refs, ineq)


def test_weighted_ls_formulation():
    """min (Ax-b)ᵀS(Ax-b) + xᵀWx without active constraints: objective
    within 1e-3 of the closed form (test_qp.py's gate)."""
    rng = np.random.default_rng(9)
    m, n = 6, 12
    A, b = rng.normal(size=(m, n)), rng.normal(size=m)
    S = np.array([1.0, 5.0, 1.0, 10.0, 10.0, 5.0])
    W = np.full(n, 1e-4)
    D, d = np.zeros((8, n)), np.full(8, -1.0)
    sol = tqp.solve_weighted_ls_qp(*map(_t, (A, S, b, W, D, d)), iters=30)
    H = 2 * A.T @ np.diag(S) @ A + np.diag(W)
    x_ref = np.linalg.solve(H, 2 * A.T @ np.diag(S) @ b)

    def obj(x):
        r = A @ x - b
        return r @ np.diag(S) @ r + x @ np.diag(W) @ x

    x = sol.x.numpy().astype(np.float64)
    assert obj(x) <= obj(x_ref) + 1e-3
    np.testing.assert_allclose(A @ x, A @ x_ref, atol=1e-3)


@pytest.mark.parametrize("what", ["prod_err", "two_sum", "split"])
def test_error_free_transforms_are_exact(what):
    """p + e == a·b and s + err == a + b exactly in float64, and the
    Dekker split is exact: a fused multiply-add or any evaluation in
    higher precision inside these transforms breaks the identities."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-3, 4, 4096)).astype(np.float32)
    b = (rng.normal(size=4096) * 10.0 ** rng.integers(-3, 4, 4096)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    if what == "prod_err":
        p, e = tqp._prod_err(ta, tb)
        got, want = p.double() + e.double(), a64 * b64
        assert (e != 0).any()  # the products do round
    elif what == "two_sum":
        s, err = tqp._two_sum(ta, tb)
        got, want = s.double() + err.double(), a64 + b64
        assert (err != 0).any()
    else:
        hi, lo = tqp._split_f32(ta)
        got, want = hi.double() + lo.double(), a64
        # hi keeps at most 12 significant bits
        m, _ = np.frexp(hi.numpy().astype(np.float64))
        assert np.all(m * 2 ** 12 == np.round(m * 2 ** 12))
    np.testing.assert_array_equal(got.numpy(), want)


def test_failed_cholesky_is_nan_not_an_error():
    """A non-positive-definite matrix gives a NaN factor (as the JAX
    Cholesky does), so the merit selection can sort it last without a
    host sync; the positive-definite one beside it is unaffected."""
    M = torch.stack([torch.eye(3), -torch.eye(3)])
    L = tqp._cholesky(M)
    assert torch.equal(L[0], torch.eye(3))
    assert torch.isnan(L[1]).all()


@pytest.mark.slow
def test_references_match_live_jax(ineq):
    """Recomputes the JAX references (XLA:CPU compiles) and repeats every
    check against them."""
    live = {k: np.asarray(v) for k, v in make_refs.qp_references().items()}
    check_worked_example(live)
    for seed in range(6):
        check_inequality(live, ineq, seed)
    for seed in range(3):
        check_equality(live, seed)
    check_warm_light(live, ineq)
