"""Unrolled batched Cholesky solve for small SPD systems (≙
``quadruped_locomotion_tpu/ops/linalgn.py::spd_solve``).

The factorization is unrolled into per-element products over the batch,
with the reciprocal of each pivot's square root stored on the diagonal
(``torch.rsqrt``), in the reference's operation order.
"""

from __future__ import annotations

import torch


def _chol(a):
    """Unrolled Cholesky of a list of lists of batched scalars; L keeps
    the reciprocal diagonal."""
    n = len(a)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        acc = a[j][j]
        for k in range(j):
            acc = acc - L[j][k] * L[j][k]
        rd = torch.rsqrt(torch.clamp(acc, min=1e-30))
        L[j][j] = rd
        for i in range(j + 1, n):
            acc2 = a[i][j]
            for k in range(j):
                acc2 = acc2 - L[i][k] * L[j][k]
            L[i][j] = acc2 * rd
    return L


def _chol_solve_list(L, b):
    """Solve L Lᵀ x = b for b a list of batched scalars."""
    n = len(b)
    y = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc * L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc * L[i][i]
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (..., n, n), b (..., n)."""
    n = A.shape[-1]
    L = _chol([[A[..., i, j] for j in range(n)] for i in range(n)])
    x = _chol_solve_list(L, [b[..., i] for i in range(n)])
    return torch.stack(x, dim=-1)
