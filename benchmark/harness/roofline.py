"""The roofline yardstick: the operations and bytes a batched
force-distribution QP solve needs, and the card's published peaks.

The four counting functions are frozen copies of
``quadruped_locomotion_tpu_torch/ops/fd_qp_kernel.py``'s (commit 8388f9c),
so that a later change to the program cannot move the bound it is read
against.
"""

from __future__ import annotations

N = 12  # primal variables (3 force components x 4 legs)
MI = 20  # inequality rows (min normal force + 4-edge pyramid x 4 legs)

# Published dense peaks (NVIDIA's H100 SXM data sheet, at the full 700 W
# power limit): float32 outside the tensor cores, and HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flop_per_s": 67e12,
                              "hbm_byte_per_s": 3.35e12},
}


def least_seconds(device_name: str, flops: float, nbytes: float):
    """The least time the card could take for ``flops`` float32 operations
    moving ``nbytes``: the larger of the compute and the memory bound.
    None for a card the table does not hold."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return max(flops / peak["f32_flop_per_s"], nbytes / peak["hbm_byte_per_s"])


def fd_qp_flops(iters: int = 15) -> int:
    """Floating-point operations one instance of the QP needs, counted
    from the algorithm in the reference's operation order
    (``qp_pallas._ipm_kernel``): G + δI formed once, D·diag(z/s) once per
    iteration and Ew = diag(w)·D once for the polish, then one
    multiply-add (2 flop) per term of each product; a division or rsqrt
    is 1; comparisons, max/min and selects are not counted. The CUDA
    kernel forms D·diag(z/s) once per iteration and Ew once, as counted
    here; what its idle lanes compute (a warp of 32 lanes runs 12- and
    20-row products) is not counted, so the roofline bound this feeds is
    the function's, not the kernel's."""

    def chol(m):  # diagonal: j FMAs + rsqrt; below: j FMAs + 1 mul
        return sum(2 * j + 1 + (m - 1 - j) * (2 * j + 1) for j in range(m))

    def solve(m):  # forward + backward: i FMAs + 1 mul per row
        return 2 * sum(2 * i + 1 for i in range(m))

    def scaled_chol(m):
        return m + 2 * (m * (m + 1) // 2) + chol(m)

    def scaled_solve(m):
        return 2 * m + solve(m)

    nt = N * (N + 1) // 2
    mt = MI * (MI + 1) // 2
    honest = N * (2 * N + 2 * MI) + MI * (2 * N + 2) + 6
    kkt_step = MI * 3 + N * 2 * MI + scaled_solve(N) + MI * (2 * N + 3)
    step_len = MI * 2 + 1
    per_iter = (
        N * (2 * N + 2 * MI)  # r_d
        + MI * (1 + 2 * N + 2) + 1  # r_p, mu
        + MI * 3  # reciprocals, z/s
        + MI * N + nt * 2 * MI  # D·diag(z/s), Schur matrix
        + scaled_chol(N)
        + MI + 2 * kkt_step + 4 * step_len  # predictor + corrector
        + MI * 6 + 1 + 3  # mu_aff, sigma
        + MI * 4 + 1  # corrector rhs
        + 3  # kkt_new
        + N * 3 + MI * 6  # step, finiteness total
    )
    start = 2 + N + chol(N) + solve(N) + MI * 2 * N
    sweep = (
        N * (2 * MI + 2 * N)  # r1 = -g + Ewᵀλ - G xp
        + MI * (2 * N + 1)  # r2 = w ⊙ (d - D xp)
        + solve(N) + MI * 2 * N  # t = G⁻¹ r1, r2 - Ew t
        + scaled_solve(MI)  # dλ
        + N * 2 * MI + solve(N)  # dx = G⁻¹ (r1 + Ewᵀ dλ)
        + N + MI  # xp, λ updates
    )
    endgame = (
        3 * honest
        + MI * 2 * N  # active set
        + MI * N + MI * solve(N)  # Ew, G⁻¹ Ewᵀ
        + mt * 2 * N + MI * 2  # K (lower half) and its diagonal
        + scaled_chol(MI)
        + solve(N)  # xp = -G⁻¹ g
        + 4 * sweep
        + MI  # λ ⊙ w
        + MI * 2 * N  # output slacks
    )
    return start + iters * per_iter + endgame


def fd_qp_bytes(batch: int) -> int:
    """Bytes the function must move: each input read once (G, g, D, d) and
    each output written once (x, s, z, kkt), float32."""
    return 4 * batch * (N * N + N + MI * N + MI + N + MI + MI + 1)


M_ROWS = 6  # rows of the wrench map A


def weighted_ls_fd_qp_flops(iters: int = 15) -> int:
    """:func:`fd_qp_flops` plus the formation of G and g per instance:
    SA = A·diag(S) (one multiply per entry), AᵀSA (one multiply-add per
    term of all 144 entries), the factor 2 and diag(W), g = −2(SA)ᵀb."""
    m, n = M_ROWS, N
    formation = m * n + 2 * m * n * n + n * n + n + 2 * m * n + n
    return fd_qp_flops(iters) + formation


def weighted_ls_fd_qp_bytes(batch: int) -> int:
    """Bytes :func:`solve_weighted_ls_fd_qp` must move: A, S, b, W, D, d
    read once (356 floats against G, g, D, d's 416), x, s, z, kkt written
    once, float32."""
    inputs = M_ROWS * N + M_ROWS + M_ROWS + N + MI * N + MI
    return 4 * batch * (inputs + N + MI + MI + 1)
