"""An independent solver of the batched force-distribution QP, in plain
PyTorch, and the numbers that judge an answer against it.

Each instance is  min 1/2 x^T G x + g^T x  s.t.  D x >= d  with
G = 2 A^T diag(S) A + diag(W) and g = -2 A^T diag(S) b (the form the
balance controller states), solved by a primal-dual interior-point
method with Mehrotra's predictor-corrector and batched LU solves (a
lower precision can leave the formed G short of positive definite).
The per-instance iterate with the smallest KKT residual is kept, so a
lower precision that stalls keeps its best answer. In float64 the
instances still above ``RETRY_KKT`` after ``ITERS`` iterations are solved
again alone for ``RETRY_ITERS``: about one in 500,000 stalls for 30-80
iterations near 1e-6 along the W = 1e-4 valley, with three feet at the
least normal force (a few others stop near 1e-8, rounding's floor).

``precision="tf32"`` is the control: every operand of every matrix
product is rounded to TF32 (10 mantissa bits, to nearest even) before a
float32 product, as the card's tensor cores would take them.
"""

from __future__ import annotations

import torch

ITERS = 50
RETRY_KKT, RETRY_ITERS = 1e-7, 400
STEP = 0.99  # fraction of the step to the boundary


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Arith:
    """Matrix products in one precision: float64, float32 or TF32."""

    def __init__(self, precision: str):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def mm(self, a, b):
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b

    def mv(self, a, v):
        return self.mm(a, v.unsqueeze(-1)).squeeze(-1)

    def cast(self, *ts):
        return tuple(t.to(self.dtype) for t in ts)


def form(A, S, W, b, ar: Arith):
    """(G, g) of the weighted least-squares QP."""
    SA = A * S[..., :, None]
    G = 2.0 * ar.mm(A.mT, SA) + torch.diag_embed(W)
    g = -2.0 * ar.mv(SA.mT, b)
    return G, g


def _residuals(G, g, D, d, x, s, z, ar):
    rd = ar.mv(G, x) + g - ar.mv(D.mT, z)
    rp = ar.mv(D, x) - s - d
    return rd, rp


def _kkt(G, g, D, d, x, z, ar):
    """Scaled KKT residual of (x, z): stationarity, primal infeasibility,
    dual infeasibility and complementarity, the largest of them."""
    slack = ar.mv(D, x) - d
    stat = (ar.mv(G, x) + g - ar.mv(D.mT, z)).abs().amax(-1)
    scale = 1.0 + g.abs().amax(-1)
    viol = torch.clamp(-slack, min=0).amax(-1) / (1.0 + d.abs().amax(-1))
    dual = torch.clamp(-z, min=0).amax(-1)
    comp = (z.abs() * slack.abs()).amax(-1) / scale
    return torch.maximum(torch.maximum(stat / scale, viol),
                         torch.maximum(dual, comp))


def _step(v, dv):
    """Largest alpha <= 1 with v + alpha dv >= (1 - STEP) v."""
    ratio = torch.where(dv < 0, -v / dv.clamp(max=-1e-300 if v.dtype ==
                                                torch.float64 else -1e-30),
                        torch.full_like(v, float("inf")))
    return torch.clamp(STEP * ratio.amin(-1), max=1.0)


def solve(G, g, D, d, ar: Arith, iters: int = ITERS):
    """(x, z, kkt) of each instance: the best iterate by KKT residual."""
    G, g, D, d = ar.cast(G, g, D, d)
    x, z, kkt = _interior_point(G, g, D, d, ar, iters)
    if ar.dtype == torch.float64:
        slow = (kkt > RETRY_KKT).nonzero().squeeze(-1)
        if slow.numel():
            x2, z2, kkt2 = _interior_point(G[slow], g[slow], D[slow], d[slow],
                                           ar, RETRY_ITERS)
            x, z, kkt = x.clone(), z.clone(), kkt.clone()
            x[slow], z[slow], kkt[slow] = x2, z2, kkt2
    return x, z, kkt


def _interior_point(G, g, D, d, ar: Arith, iters: int):
    m = d.shape[-1]
    x = torch.linalg.solve(G, -g)
    s = torch.clamp(ar.mv(D, x) - d, min=1.0)
    z = torch.ones_like(d)
    best_x, best_z = x, z
    best = _kkt(G, g, D, d, x, z, ar)
    for _ in range(iters):
        rd, rp = _residuals(G, g, D, d, x, s, z, ar)
        mu = (s * z).sum(-1) / m
        M = G + ar.mm(D.mT, D * (z / s)[..., None])
        LU, piv, info = torch.linalg.lu_factor_ex(M)
        ok = info == 0

        def newton(rc):
            rhs = -rd - ar.mv(D.mT, (rc + z * rp) / s)
            dx = torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1)).squeeze(-1)
            ds = rp + ar.mv(D, dx)
            dz = -(rc + z * ds) / s
            return dx, ds, dz

        dx, ds, dz = newton(s * z)
        ap, ad = _step(s, ds), _step(z, dz)
        mu_aff = ((s + ap[:, None] * ds) * (z + ad[:, None] * dz)).sum(-1) / m
        sigma = torch.clamp(mu_aff / mu.clamp(min=1e-300 if mu.dtype ==
                                               torch.float64 else 1e-30),
                            0.0, 1.0) ** 3
        dx2, ds2, dz2 = newton(s * z + ds * dz - (sigma * mu)[:, None])
        ap, ad = _step(s, ds2), _step(z, dz2)
        new_x = x + ap[:, None] * dx2
        new_s = s + ap[:, None] * ds2
        new_z = z + ad[:, None] * dz2
        finite = (ok & torch.isfinite(new_x).all(-1) & torch.isfinite(new_s)
                  .all(-1) & torch.isfinite(new_z).all(-1))[:, None]
        x = torch.where(finite, new_x, x)
        s = torch.where(finite, new_s, s)
        z = torch.where(finite, new_z, z)
        k = _kkt(G, g, D, d, x, z, ar)
        better = k < best
        best_x = torch.where(better[:, None], x, best_x)
        best_z = torch.where(better[:, None], z, best_z)
        best = torch.where(better, k, best)
    return best_x, best_z, best


def ls_objective(A, S, W, b, x):
    """(Ax - b)^T diag(S) (Ax - b) + 1/2 x^T diag(W) x in float64: the QP's
    objective plus the constant b^T S b, so that it is >= 0."""
    A, S, W, b, x = (t.double() for t in (A, S, W, b, x))
    r = (A @ x.unsqueeze(-1)).squeeze(-1) - b
    return (r * S * r).sum(-1) + 0.5 * (x * W * x).sum(-1)


def judge(A, b, S, W, D, d, x, x_ref) -> dict:
    """Per instance: the objective gap of ``x`` above the reference's
    optimum ``x_ref``, relative to 1 + the optimum, and how far ``x``
    violates D x >= d (N)."""
    j = ls_objective(A, S, W, b, x)
    j_ref = ls_objective(A, S, W, b, x_ref)
    viol = torch.clamp(d.double() - (D.double() @ x.double().unsqueeze(-1))
                       .squeeze(-1), min=0.0).amax(-1)
    gap = (j - j_ref).abs() / (1.0 + j_ref)
    return {"gap": gap, "viol": viol}
