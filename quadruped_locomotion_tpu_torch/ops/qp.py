"""Generic dense QP solver, batched over leading dimensions (≙
``quadruped_locomotion_tpu/ops/qp.py``).

Solves, per instance,

    min ½ xᵀG x + gᵀx   s.t.   C x = c,   D x ≥ d

with a fixed-iteration Mehrotra predictor-corrector interior-point method
(one Jacobi-equilibrated Cholesky of the n×n Schur matrix and two
triangular solve pairs per iteration; a ``done`` freeze keeps converged
iterates fixed), then an active-set polish whose candidates are ranked
by an exact-penalty merit evaluated with error-free transforms.

Disabled rows: zero the row of D and set d ≤ -1. Shapes: G (..., n, n),
g (..., n), D (..., mi, n), d (..., mi), optional C (..., me, n),
c (..., me); every leading dimension is a batch dimension.

PyTorch idiom: the ``lax.scan`` over iterations is a Python loop with
``torch.where`` freezes; Cholesky and LU use the ``_ex`` variants, whose
failed factors become NaN (as ``jnp.linalg.cholesky`` returns), so no
call syncs the host. The error-free transforms rely on every product and
sum being rounded to float32 on its own, which eager PyTorch guarantees
(one op, one rounding): they are written as separate plain ops, with no
fused multiply-add (``addcmul``/``addmm``) and no ``torch.compile``. The
reference's ``_barrier`` (an XLA optimization barrier) is therefore the
identity here and is not needed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class QpSolution(NamedTuple):
    x: torch.Tensor  # (..., n) primal solution
    z: torch.Tensor  # (..., mi) inequality multipliers
    y: torch.Tensor  # (..., me) equality multipliers (empty without equalities)
    s: torch.Tensor  # (..., mi) slacks Dx - d
    iterations: torch.Tensor  # (...,) int
    kkt_error: torch.Tensor  # (...,) final KKT residual


# ---------------------------------------------------------------------------
# batched linear algebra on flat (B, ...) tensors
# ---------------------------------------------------------------------------


def _mv(A, v):
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def _mtv(A, v):
    return (A.mT @ v.unsqueeze(-1)).squeeze(-1)


def _cholesky(M):
    """Lower Cholesky factor of the symmetrised M; NaN where M is not
    positive definite (``jnp.linalg.cholesky``'s behaviour)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (M + M.mT))
    return torch.where((info == 0)[:, None, None], L,
                       torch.full_like(L, math.nan))


def _chol_solve(L, b):
    """Solve (L Lᵀ) x = b for b (B, n) or (B, n, k)."""
    vec = b.dim() == 2
    rhs = b.unsqueeze(-1) if vec else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x.squeeze(-1) if vec else x


def _solve(M, b):
    """Batched LU solve of M x = b (b (B, m)) without a host sync."""
    return torch.linalg.solve_ex(M, b.unsqueeze(-1))[0].squeeze(-1)


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _amax(v):
    """max over the last axis; -inf for an empty axis."""
    if v.shape[-1] == 0:
        return torch.full(v.shape[:-1], -math.inf, dtype=v.dtype,
                          device=v.device)
    return v.amax(-1)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


def solve_qp(
    G: torch.Tensor,
    g: torch.Tensor,
    D: torch.Tensor,
    d: torch.Tensor,
    C: torch.Tensor | None = None,
    c: torch.Tensor | None = None,
    iters: int = 25,
    tol: float | None = None,
    warm: tuple[torch.Tensor, torch.Tensor] | None = None,
    polish: str = "full",
) -> QpSolution:
    """Solve a batch of QPs (every leading dimension is a batch axis).

    Products run in full float32 as long as TF32 stays off (the default;
    see ``types.full_f32_matmuls``): TF32 rounding is catastrophic for
    the IPM's KKT systems, whose condition grows like 1/μ.

    ``warm`` = (x_prev, z_prev): start from the previous optimum of a
    slowly varying problem (slacks floored at 1e-2, duals clipped to
    [1e-2, 1e6]). ``polish`` = "full" (2 candidate active sets + 3
    chained steps, 4 refinement rounds each) or "light" (1 candidate +
    1 chained step, 3 rounds).
    """
    if polish not in ("full", "light"):
        raise ValueError(f"unknown polish {polish!r}")
    lead = G.shape[:-2]
    n, mi = G.shape[-1], D.shape[-2]
    B = math.prod(lead)

    def flat(t, tail):
        return None if t is None else t.reshape((B,) + tuple(tail))

    has_eq = C is not None
    me = C.shape[-2] if has_eq else 0
    Gf, gf, Df, df = flat(G, (n, n)), flat(g, (n,)), flat(D, (mi, n)), flat(d, (mi,))
    Cf, cf = flat(C, (me, n)), flat(c, (me,))
    warm_f = None if warm is None else (flat(warm[0], (n,)), flat(warm[1], (mi,)))
    sol = _solve_qp_impl(Gf, gf, Df, df, Cf, cf, iters, tol, warm_f, polish)
    return QpSolution(*(t.reshape(lead + t.shape[1:]) for t in sol))


def _honest_kkt(G, g, D, d, x, z, scale_g, scale_d, C=None, c=None, y=None):
    """Full KKT residual of a candidate (x, z): stationarity, primal
    violation, mean complementarity, dual sign (per instance)."""
    mi = D.shape[-2]
    stat = _mv(G, x) + g - _mtv(D, z)
    if C is not None:
        stat = stat - _mtv(C, y)
    slack = _mv(D, x) - d
    viol = _amax(torch.clamp(-slack, min=0.0))
    comp = (z * slack.abs()).sum(-1) / mi
    dual = _amax(torch.clamp(-z, min=0.0)) / (1.0 + _amax(z.abs()))
    kkt = torch.maximum(
        torch.maximum(_amax(stat.abs()) / scale_g, dual),
        torch.maximum(viol / scale_d, comp / scale_g),
    )
    if C is not None:
        kkt = torch.maximum(kkt, _amax((_mv(C, x) - c).abs()) / scale_d)
    return kkt


def _solve_qp_impl(G, g, D, d, C, c, iters, tol, warm, polish) -> QpSolution:
    dtype = G.dtype
    B, n = G.shape[0], G.shape[-1]
    mi = D.shape[-2]
    has_eq = C is not None
    me = C.shape[-2] if has_eq else 0
    f64 = dtype == torch.float64

    if tol is None:
        tol = 1e-10 if f64 else 1e-6
    s_floor = 1e-14 if f64 else 1e-9
    delta = 1e-9 if f64 else 1e-6
    G_reg = G + delta * _eye(n, G)
    scale_g = 1.0 + _amax(g.abs())
    scale_d = 1.0 + _amax(d.abs())

    # --- starting point ---------------------------------------------------
    chol0 = _cholesky(G_reg)
    x0 = _chol_solve(chol0, -g)
    if has_eq:
        GiCt = _chol_solve(chol0, C.mT)
        schur_e = C @ GiCt + delta * _eye(me, G)
        y0 = _solve(schur_e, c - _mv(C, x0))
        x0 = x0 + _mv(GiCt, y0)
    else:
        y0 = G.new_zeros((B, 0))

    if warm is None:
        s0 = torch.clamp(_mv(D, x0) - d, min=1.0)
        z0 = torch.ones_like(d)
    else:
        xw, zw = warm
        ok = torch.isfinite(xw).all(-1, keepdim=True)
        x0 = torch.where(ok, xw, x0)
        s0 = torch.clamp(_mv(D, x0) - d, min=1e-2)
        z0 = torch.clamp(torch.where(torch.isfinite(zw), zw,
                                     torch.ones_like(zw)), 1e-2, 1e6)

    def step_len(v, dv):
        """Fraction-to-boundary: max α ∈ (0,1] with v + α dv ≥ (1-τ) v."""
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                            torch.full_like(dv, math.inf))
        return torch.clamp(0.995 * ratio.amin(-1), max=1.0)

    x, s, z, y = x0, s0, z0, y0
    xb, sb, zb, yb = x0, s0, z0, y0
    kb = torch.full((B,), math.inf, dtype=dtype, device=G.device)
    done = torch.zeros((B,), dtype=torch.bool, device=G.device)
    it_count = torch.zeros((B,), dtype=torch.int32, device=G.device)
    for _ in range(iters):
        r_d = _mv(G, x) + g - _mtv(D, z)
        if has_eq:
            r_d = r_d - _mtv(C, y)
            r_e = _mv(C, x) - c
        r_p = _mv(D, x) - d - s
        mu = (s * z).sum(-1) / mi

        s_safe = torch.clamp(s, min=s_floor)
        zs = z / s_safe
        M = G_reg + (D.mT * zs[:, None, :]) @ D
        # Jacobi equilibration before the Cholesky keeps the float32
        # factor finite deep into the endgame, where z/s reaches 1/eps.
        dsc = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                                      min=s_floor))
        chol = _cholesky(M * dsc[:, :, None] * dsc[:, None, :])

        def msolve(b):
            """M⁻¹ b through the equilibrated factor (vector or matrix)."""
            scale = dsc[:, :, None] if b.dim() == 3 else dsc
            return scale * _chol_solve(chol, scale * b)

        def kkt_step(r_c):
            rhs = -r_d - _mtv(D, (r_c + z * r_p) / s_safe)
            if has_eq:
                MiCt = msolve(C.mT)
                Mirhs = msolve(rhs)
                schur = C @ MiCt + delta * _eye(me, G)
                dy = _solve(schur, -_mv(C, Mirhs) - r_e)
                dx = Mirhs + _mv(MiCt, dy)
            else:
                dy = y
                dx = msolve(rhs)
            ds = _mv(D, dx) + r_p
            dz = -(r_c + z * ds) / s_safe
            return dx, ds, dz, dy

        # predictor (affine scaling)
        dx_a, ds_a, dz_a, _ = kkt_step(s * z)
        alpha_p = step_len(s, ds_a)[:, None]
        alpha_d = step_len(z, dz_a)[:, None]
        mu_aff = ((s + alpha_p * ds_a) * (z + alpha_d * dz_a)).sum(-1) / mi
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)

        # corrector with Mehrotra's second-order term
        r_c = s * z + ds_a * dz_a - (sigma * mu)[:, None]
        dx, ds, dz, dy = kkt_step(r_c)
        alpha = torch.minimum(step_len(s, ds), step_len(z, dz))[:, None]

        x_new = x + alpha * dx
        s_new = s + alpha * ds
        z_new = z + alpha * dz
        y_new = y + alpha * dy if has_eq else y

        # kkt_new measures the CURRENT iterate: track the best point by it
        kkt_new = torch.maximum(
            _amax(r_d.abs()) / scale_g,
            torch.maximum(_amax(r_p.abs()) / scale_d, mu / scale_g),
        )
        if has_eq:
            kkt_new = torch.maximum(kkt_new, _amax(r_e.abs()) / scale_d)
        better = kkt_new < kb
        b1 = better[:, None]
        xb = torch.where(b1, x, xb)
        sb = torch.where(b1, s, sb)
        zb = torch.where(b1, z, zb)
        if has_eq:
            yb = torch.where(b1, y, yb)
        kb = torch.where(better, kkt_new, kb)

        # freeze converged instances and any non-finite update
        bad = ~torch.isfinite(x_new.sum(-1) + s_new.sum(-1) + z_new.sum(-1))
        newly_done = (kkt_new < tol) | bad
        keep = ~(done | bad)
        k1 = keep[:, None]
        it_count = it_count + (~done).to(torch.int32)
        x = torch.where(k1, x_new, x)
        s = torch.where(k1, s_new, s)
        z = torch.where(k1, z_new, z)
        if has_eq:
            y = torch.where(k1, y_new, y)
        done = done | newly_done

    # better of (last, best-so-far) by the honest point residual
    k_last = _honest_kkt(G, g, D, d, x, z, scale_g, scale_d,
                         C=C, c=c, y=y if has_eq else None)
    k_best = _honest_kkt(G, g, D, d, xb, zb, scale_g, scale_d,
                         C=C, c=c, y=yb if has_eq else None)
    take_last = k_last <= k_best
    t1 = take_last[:, None]
    x = torch.where(t1, x, xb)
    s = torch.where(t1, s, sb)
    z = torch.where(t1, z, zb)
    if has_eq:
        y = torch.where(t1, y, yb)
    kkt = torch.where(take_last, k_last, k_best)

    # Active-set polish with candidates ranked by the exact-penalty merit
    # (see _merit_dd): with ρ > ‖λ*‖∞ its minimum over the candidates is
    # the constrained optimum, and it needs no stationarity measurement.
    slack_ipm = _mv(D, x) - d
    act_slack = (slack_ipm < 1e-5 * (1.0 + d.abs())).to(dtype)
    rho = 10.0 * (1.0 + _amax(z.abs()))
    sel = {"x": x, "z": z, "s": s, "y": y, "kkt": kkt,
           "merit": _merit_dd(G, g, D, d, x, rho, C=C, c=c)}

    def consider(x_p, z_p, y_p):
        k_pol = _honest_kkt(G, g, D, d, x_p, z_p, scale_g, scale_d,
                            C=C, c=c, y=y_p if has_eq else None)
        merit_new = _merit_dd(G, g, D, d, x_p, rho, C=C, c=c)
        take = _dd_less(merit_new, sel["merit"])  # False on a NaN merit
        t = take[:, None]
        sel["x"] = torch.where(t, x_p, sel["x"])
        sel["z"] = torch.where(t, z_p, sel["z"])
        sel["s"] = torch.where(t, torch.clamp(_mv(D, x_p) - d, min=0.0),
                               sel["s"])
        if has_eq:
            sel["y"] = torch.where(t, y_p, sel["y"])
        sel["kkt"] = torch.where(take, k_pol, sel["kkt"])
        sel["merit"] = tuple(torch.where(take, new, old)
                             for new, old in zip(merit_new, sel["merit"]))

    light = polish == "light"
    rounds = 3 if light else 4
    for act in ((None,) if light else (None, act_slack)):
        consider(*_polish(G, g, D, d, chol0, delta, x, z, C=C, c=c,
                          rounds=rounds, act=act))

    # Iterated active-set chain: re-identify the active set from each
    # polished point (drop rows with negative multipliers, add violated
    # rows) and polish again; only the best point by merit is returned.
    x_c, z_c = x, z
    for _ in range(1 if light else 3):
        slack_c = _mv(D, x_c) - d
        act_c = ((z_c > slack_c) | (slack_c < 0.0)).to(dtype)
        x_c, z_c, y_c = _polish(G, g, D, d, chol0, delta, x_c, z_c, C=C, c=c,
                                rounds=rounds, act=act_c)
        consider(x_c, z_c, y_c)
    return QpSolution(x=sel["x"], z=sel["z"], y=sel["y"], s=sel["s"],
                      iterations=it_count, kkt_error=sel["kkt"])


# ---------------------------------------------------------------------------
# error-free transforms (each line one rounding; see the module docstring)
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """Knuth two-sum: s = fl(a+b) and the exact rounding error err."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split_f32(a):
    """Dekker split: a = hi + lo with a 12-bit hi mantissa (float32)."""
    c = a * 4097.0  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _prod_err(a, b):
    """Error-free product: p = fl(a·b) and e exact with p + e = a·b."""
    p = a * b
    ha, la = _split_f32(a)
    hb, lb = _split_f32(b)
    e = ((ha * hb - p) + ha * lb + la * hb) + lb * la
    return p, e


def _comp_sum(pairs):
    """Compensated (Neumaier) sum of (value, error) pairs."""
    s, comp = pairs[0]
    for p, e in pairs[1:]:
        s, err = _two_sum(s, p)
        comp = comp + (err + e)
    return s + comp


def _obj_dd(G, g, x):
    """Double-float objective ½xᵀGx + gᵀx as an unevaluated (hi, lo)
    pair per instance, compared with :func:`_dd_less`."""
    n = G.shape[-1]
    P, E = _prod_err(G, x[:, None, :])  # column j: G[:, j]·x_j
    hi, lo = P[..., 0], E[..., 0]
    for j in range(1, n):
        hi, err = _two_sum(hi, P[..., j])
        lo = lo + (err + E[..., j])
    # obj = Σ_i x_i·(g_i + ½t_i), terms in the reference's order
    pg, eg = _prod_err(x, g)
    ph, eh = _prod_err(x, 0.5 * hi)
    pl = x * (0.5 * lo)
    terms = []
    for i in range(n):
        terms += [(pg[:, i], eg[:, i]), (ph[:, i], eh[:, i]),
                  (pl[:, i], torch.zeros_like(pl[:, i]))]
    s, comp = terms[0]
    for p, e in terms[1:]:
        s, err = _two_sum(s, p)
        comp = comp + (err + e)
    return s, comp


def _dd_less(a, b):
    """a < b for double-float pairs (hi, lo)."""
    d, e = _two_sum(a[0], -b[0])
    return d + (e + (a[1] - b[1])) < 0.0


def _row_products(M, v, negate=False):
    """Error-free products of the columns of M (B, m, n) with v (B, n),
    as the list of (M[:, :, j]·v_j, error) pairs over j."""
    P, E = _prod_err(-M if negate else M, v[:, None, :])
    return [(P[..., j], E[..., j]) for j in range(M.shape[-1])]


def _viol_comp(D, d, x, C=None, c=None):
    """Total violation Σ max(d−Dx, 0) (+ Σ|Cx−c|) with compensated row
    dot products."""
    slack = _comp_sum([(-d, torch.zeros_like(d))] + _row_products(D, x))
    viol = torch.clamp(-slack, min=0.0).sum(-1)
    if C is not None:
        r = _comp_sum([(-c, torch.zeros_like(c))] + _row_products(C, x))
        viol = viol + r.abs().sum(-1)
    return viol


def _merit_dd(G, g, D, d, x, rho, C=None, c=None):
    """Exact-penalty merit φ(x) = obj(x) + ρ·viol(x) as a double-float
    pair; non-finite candidates sort to +inf."""
    hi, lo = _obj_dd(G, g, x)
    pv = rho * _viol_comp(D, d, x, C=C, c=c)
    s, e = _two_sum(hi, pv)
    lo = lo + e
    bad = ~(torch.isfinite(s) & torch.isfinite(lo))
    return (torch.where(bad, torch.full_like(s, math.inf), s),
            torch.where(bad, torch.zeros_like(lo), lo))


def _stationarity_comp(g, Ew, lam, G, xp):
    """Compensated stationarity residual r1 = −g + Ewᵀλ − G·xp."""
    P, E = _prod_err(Ew, lam[:, :, None])  # row k: Ew[k]·λ_k
    pairs = [(-g, torch.zeros_like(g))]
    pairs += [(P[:, k], E[:, k]) for k in range(Ew.shape[-2])]
    pairs += _row_products(G, xp, negate=True)
    return _comp_sum(pairs)


def _eq_residual_comp(e, E, xp, w):
    """Compensated r2 = w ⊙ (e − E·xp)."""
    return w * _comp_sum([(e, torch.zeros_like(e))]
                         + _row_products(E, xp, negate=True))


def _polish(G, g, D, d, chol_g, delta, x_ipm, z_ipm, C=None, c=None,
            rounds: int = 4, act=None):
    """Equality-constrained re-solve on the active set of (x_ipm, z_ipm)
    (z > slack unless ``act`` is given; equality rows always active),
    through the Schur complement on the factored G_reg with ``rounds``
    compensated refinement sweeps. Inactive rows carry an identity
    diagonal and a zero right-hand side. Returns (x, z, y or None)."""
    dtype = G.dtype
    slack = _mv(D, x_ipm) - d
    if act is None:
        act = (z_ipm > slack).to(dtype)
    if C is not None:
        E = torch.cat([C, D], dim=-2)
        e = torch.cat([c, d], dim=-1)
        w = torch.cat([torch.ones_like(c), act], dim=-1)
    else:
        E, e, w = D, d, act
    m = E.shape[-2]

    Ew = E * w[:, :, None]
    K = (Ew @ _chol_solve(chol_g, Ew.mT) + torch.diag_embed(1.0 - w)
         + delta * _eye(m, G))
    cholK = _cholesky(K)

    xp = _chol_solve(chol_g, -g)
    lam = torch.zeros_like(e)
    for _ in range(rounds):
        r1 = _stationarity_comp(g, Ew, lam, G, xp)
        r2 = _eq_residual_comp(e, E, xp, w)
        t = _chol_solve(chol_g, r1)
        dlam = _chol_solve(cholK, r2 - _mv(Ew, t))
        xp = xp + _chol_solve(chol_g, r1 + _mtv(Ew, dlam))
        lam = lam + dlam
    lam = lam * w
    if C is not None:
        me = C.shape[-2]
        return xp, lam[:, me:], lam[:, :me]
    return xp, lam, None


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------


def solve_weighted_ls_qp(
    A: torch.Tensor,
    S: torch.Tensor,
    b: torch.Tensor,
    W: torch.Tensor,
    D: torch.Tensor,
    d: torch.Tensor,
    C: torch.Tensor | None = None,
    c: torch.Tensor | None = None,
    iters: int = 25,
    warm: tuple[torch.Tensor, torch.Tensor] | None = None,
    polish: str = "full",
) -> QpSolution:
    """min (Ax−b)ᵀS(Ax−b) + xᵀWx s.t. Cx = c, Dx ≥ d, through
    G = 2AᵀSA + diag(W), g = −2AᵀSb (S and W as diagonal vectors)."""
    SA = A * S[..., :, None]
    G = 2.0 * (A.mT @ SA) + torch.diag_embed(W)
    g = -2.0 * _mv(SA.mT, b)
    return solve_qp(G, g, D, d, C=C, c=c, iters=iters, warm=warm,
                    polish=polish)


def kkt_residuals(G, g, D, d, sol: QpSolution, C=None, c=None) -> dict:
    """Diagnostic KKT residuals (stationarity, feasibility,
    complementarity, dual sign; equality), each a max over its rows."""
    stat = _mv(G, sol.x) + g - _mtv(D, sol.z)
    if C is not None:
        stat = stat - _mtv(C, sol.y)
    slack = _mv(D, sol.x) - d
    out = {
        "stationarity": _amax(stat.abs()),
        "primal": _amax(torch.clamp(slack, max=0.0).abs()),
        "complementarity": _amax((sol.z * slack).abs()),
        "dual": _amax(torch.clamp(-sol.z, min=0.0)),
    }
    if C is not None:
        out["equality"] = _amax((_mv(C, sol.x) - c).abs())
    return out
