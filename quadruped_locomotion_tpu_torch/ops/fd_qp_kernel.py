"""Batched force-distribution QP: the hand-written CUDA kernel, its build,
its wrapper, and its plain PyTorch version (≙ ``quadruped_locomotion_tpu/
ops/qp_pallas.py``).

Each instance solves  min ½xᵀGx + gᵀx  s.t.  Dx ≥ d  with n = 12 forces
and mi = 20 inequality rows by a fixed-iteration Mehrotra
predictor-corrector with an active-set polish; see
``csrc/fd_qp_ipm.cu`` for the algorithm and for what bounds it on an
H100.

:func:`solve_fd_qp` is the entry point. On CUDA tensors it launches the
kernel (built from the repository's source with ``nvcc`` at first use)
or raises; on CPU tensors it runs :func:`solve_fd_qp_plain`, the same
algorithm vectorised over the batch, which the tests hold against the
JAX reference and which the GPU smoke run holds the kernel against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

N = 12  # primal variables (3 force components × 4 legs)
MI = 20  # inequality rows (min normal force + 4-edge pyramid × 4 legs)

_DELTA = 1e-6  # Tikhonov regularization
_S_FLOOR = 1e-9
_TOL = 1e-6

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fd_qp_ipm.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Number of kernel launches made by solve_fd_qp (the plain CPU path does
# not count). Callers reset it to 0 and read it to show that a run went
# through the kernel.
launches = 0
# Calls of solve_weighted_ls_fd_qp that launched the kernel (each one is
# also one of ``launches``).
wls_launches = 0


@dataclass
class KernelBuild:
    path: Path  # the shared library
    seconds: float  # nvcc wall time of this process's build, 0.0 if reused
    log: str  # nvcc / ptxas output (-Xptxas -v: registers, spills)
    threads_per_block: int  # launch geometry, read from the library; one
    # warp (32 lanes) solves one instance


def ptxas_report(log: str) -> dict:
    """Registers, shared memory, stack frame and spill bytes of the kernel
    from ``-Xptxas -v`` output (largest over the functions listed). Raises
    ValueError if the log holds no such report."""
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    used = re.findall(r"Used (\d+) registers", log)
    smem = re.findall(r"(\d+) bytes smem", log)
    if not frames or not used:
        raise ValueError("no ptxas register/spill report in the build log")
    top = lambda rows, i: max(int(r[i]) for r in rows)  # noqa: E731
    return dict(registers=max(map(int, used)),
                smem_bytes=max(map(int, smem), default=0),
                stack_bytes=top(frames, 0), spill_store_bytes=top(frames, 1),
                spill_load_bytes=top(frames, 2))


_build: KernelBuild | None = None
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


def build_kernel() -> KernelBuild:
    """Compile ``csrc/fd_qp_ipm.cu`` into ``build/`` (once per source hash)
    and load it (once per process). Raises if nvcc fails."""
    global _build, _lib
    if _build is not None:
        return _build
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"fd_qp_ipm-{digest[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        # both renames are atomic: a process that finds the library (ranks
        # of one host may build at once) finds its whole log beside it
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp_log, log_path)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.fd_qp_ipm.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fd_qp_ipm.restype = ctypes.c_int
    lib.fd_qp_ipm_error_string.argtypes = [ctypes.c_int]
    lib.fd_qp_ipm_error_string.restype = ctypes.c_char_p
    _lib = lib
    _build = KernelBuild(
        path=so, seconds=seconds,
        log=log_path.read_text() if log_path.exists() else "",
        threads_per_block=lib.fd_qp_ipm_threads_per_block(),
    )
    return _build


def _check(G, g, D, d):
    B = G.shape[0]
    shapes = {"G": (G, (B, N, N)), "g": (g, (B, N)),
              "D": (D, (B, MI, N)), "d": (d, (B, MI))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != G.device:
            raise ValueError(f"{name} is on {t.device}, G on {G.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def solve_fd_qp(G, g, D, d, iters: int = 15):
    """Batched force-distribution QP: min ½xᵀGx + gᵀx s.t. Dx ≥ d.

    G (B,12,12), g (B,12), D (B,20,12), d (B,20), float32, contiguous, on
    one device. Returns (x (B,12), s (B,20), z (B,20), kkt (B,)).

    CUDA tensors go to the kernel (one launch; raises if it cannot be
    built or launched); CPU tensors to :func:`solve_fd_qp_plain`.
    """
    _check(G, g, D, d)
    if G.device.type == "cpu":
        return solve_fd_qp_plain(G, g, D, d, iters)
    if G.device.type != "cuda":
        raise ValueError(f"unsupported device {G.device}")
    return launch_fd_qp(G, g, D, d, iters)


def launch_fd_qp(G, g, D, d, iters: int = 15):
    """One kernel launch: G (B,12,12), g (B,12), D (B,20,12), d (B,20),
    contiguous float32 tensors on one CUDA device, read in place (one
    instance's entries are contiguous, so a warp's loads coalesce).
    Returns contiguous x (B,12), s (B,20), z (B,20), kkt (B,). Raises on
    anything else, and if the kernel cannot be built or launched."""
    global launches
    B = G.shape[0]
    for name, t, shape in (("G", G, (B, N, N)), ("g", g, (B, N)),
                           ("D", D, (B, MI, N)), ("d", d, (B, MI))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device.type != "cuda" or t.device != G.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 CUDA tensor of shape "
                f"{shape} on G's device, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    build_kernel()
    dev = G.device
    x = torch.empty((B, N), dtype=torch.float32, device=dev)
    s = torch.empty((B, MI), dtype=torch.float32, device=dev)
    z = torch.empty((B, MI), dtype=torch.float32, device=dev)
    kkt = torch.empty((B,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib.fd_qp_ipm(
        G.data_ptr(), g.data_ptr(), D.data_ptr(), d.data_ptr(),
        x.data_ptr(), s.data_ptr(), z.data_ptr(), kkt.data_ptr(),
        B, iters, stream,
    )
    if rc != 0:
        raise RuntimeError(
            "fd_qp_ipm launch failed: "
            + _lib.fd_qp_ipm_error_string(rc).decode()
        )
    launches += 1
    return x, s, z, kkt


def form_quadratic(A, S, W, b):
    """G = 2AᵀSA + diag(W), g = −2AᵀSb for A (..., 6, 12), S (..., 6),
    W (..., 12), b (..., 6), in full float32 (callers keep TF32 off, see
    ``types.full_f32_matmuls``)."""
    SA = A * S[..., :, None]
    g = ((-2.0 * SA.mT) @ b.unsqueeze(-1)).squeeze(-1)
    return (2.0 * A.mT) @ SA + torch.diag_embed(W), g


def solve_weighted_ls_fd_qp(A, S, b, W, D, d, iters: int = 15):
    """Batched weighted least-squares form of the force-distribution QP
    (≙ ``qp_pallas.solve_weighted_ls_fd_qp``):

        min (Ax − b)ᵀ diag(S) (Ax − b) + xᵀ diag(W) x   s.t.   Dx ≥ d

    with A (B,6,12), S (B,6), b (B,6), W (B,12), D (B,20,12), d (B,20).
    Forms G = 2AᵀSA + diag(W) and g = −2AᵀSb as plain batched float32
    products (the reference forms them outside its kernel too), then
    calls :func:`solve_fd_qp`: one kernel launch on CUDA tensors, the
    plain version on CPU tensors. Returns (x, s, z, kkt)."""
    global wls_launches
    G, g = form_quadratic(A, S, W, b)
    out = solve_fd_qp(G.contiguous(), g.contiguous(), D.contiguous(),
                      d.contiguous(), iters)
    if G.device.type == "cuda":
        wls_launches += 1
    return out


def solve_weighted_ls_fd_qp_plain(A, S, b, W, D, d, iters: int = 15):
    """:func:`solve_weighted_ls_fd_qp` through the plain version on any
    device (for comparisons on the card)."""
    G, g = form_quadratic(A, S, W, b)
    return solve_fd_qp_plain(G, g, D, d, iters)


# ---------------------------------------------------------------------------
# Plain PyTorch version: the reference kernel's operations in the
# reference kernel's order (``qp_pallas._ipm_kernel``, as its eager trace
# ``solve_fd_qp_emulated`` runs them), vectorised over the batch and over
# the independent rows of each step. Every sum accumulates term by term in
# the trace's order as separate float32 products and sums (one op, one
# rounding: no matmul, no reduction kernel, no fused multiply-add), and
# factors keep the trace's reciprocal diagonal. Maxima and minima are
# order-free. The one operation whose rounding can differ is rsqrt
# (``torch.rsqrt`` against XLA's, within 2 ulp).
# ---------------------------------------------------------------------------


def _col(t, like):
    """A (B,) per-instance scalar broadcast against ``like`` (B, ...)."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _cholesky(M):
    """Lower factor of M (B, m, m), column by column as the trace: its
    diagonal holds rsqrt(max(·, 1e-30)), the reciprocal of the pivot."""
    m = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(m):
        acc = M[:, j, j]
        for k in range(j):
            acc = acc - L[:, j, k] * L[:, j, k]
        rdiag = torch.rsqrt(torch.clamp(acc, min=1e-30))
        L[:, j, j] = rdiag
        if j + 1 < m:
            acc2 = M[:, j + 1:, j]
            for k in range(j):
                acc2 = acc2 - L[:, j + 1:, k] * L[:, j, k:k + 1]
            L[:, j + 1:, j] = acc2 * rdiag[:, None]
    return L


def _chol_solve(L, b):
    """Solve (L Lᵀ) x = b for b (B, m) or (B, m, r): forward then backward
    substitution, row by row, multiplying by the stored reciprocal."""
    m = L.shape[-1]
    y = [None] * m
    for i in range(m):
        acc = b[:, i]
        for k in range(i):
            acc = acc - _col(L[:, i, k], acc) * y[k]
        y[i] = acc * _col(L[:, i, i], acc)
    x = [None] * m
    for i in reversed(range(m)):
        acc = y[i]
        for k in range(i + 1, m):
            acc = acc - _col(L[:, k, i], acc) * x[k]
        x[i] = acc * _col(L[:, i, i], acc)
    return torch.stack(x, dim=1)


def _scaled_cholesky(M):
    """Jacobi-equilibrated factor of diag(s)·M·diag(s), s = rsqrt(diag M)."""
    dsc = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                                  min=1e-30))
    return _cholesky(M * dsc[:, :, None] * dsc[:, None, :]), dsc


def _scaled_solve(L, dsc, b):
    return _chol_solve(L, b * dsc) * dsc


def _dot_rows(acc, A, v, sign=1.0):
    """acc[r] ± Σ_c A[r, c]·v[c], term by term over c: A (B, R, C),
    v (B, C)."""
    for c in range(A.shape[-1]):
        term = A[:, :, c] * v[:, c:c + 1]
        acc = acc + term if sign > 0 else acc - term
    return acc


def _dot_cols(acc, A, v, sign=1.0):
    """acc[c] ± Σ_r A[r, c]·v[r], term by term over r: A (B, R, C),
    v (B, R)."""
    for r in range(A.shape[1]):
        term = A[:, r, :] * v[:, r:r + 1]
        acc = acc + term if sign > 0 else acc - term
    return acc


def _sum_terms(t):
    """Σ_k t[:, k] term by term from 0 (B, K) -> (B,)."""
    acc = torch.zeros_like(t[:, 0])
    for k in range(t.shape[-1]):
        acc = acc + t[:, k]
    return acc


def _stationarity(g, G, x, D, z):
    """g + G x − Dᵀ z, row by row: the j sum, then the k sum."""
    return _dot_cols(_dot_rows(g, G, x), D, z, -1.0)


def _slack(D, d, x):
    """−d + D x, term by term over the columns."""
    return _dot_rows(-d, D, x)


def _step_len_recip(rv, dv):
    """min(1, 0.995 / max_k(-dv·rv | dv < 0)), 1 where no dv < 0."""
    m = torch.where(dv < 0.0, -dv * rv, torch.zeros_like(dv)).amax(-1)
    # a true division (a Python number over a tensor is a reciprocal and
    # a product in PyTorch: two roundings)
    alpha = torch.full_like(m, 0.995) / torch.clamp(m, min=1e-30)
    return torch.where(m > 0.0, torch.clamp(alpha, max=1.0),
                       torch.ones_like(m))


def _honest_kkt(G, g, D, d, x, z, scale_g, scale_d):
    stat = _stationarity(g, G, x, D, z).abs().amax(-1)
    slack = _slack(D, d, x)
    viol = torch.clamp(-slack, min=0.0).amax(-1)
    comp = slack[:, 0] * 0.0
    for k in range(MI):
        comp = comp + z[:, k] * slack[:, k].abs()
    comp = comp * (1.0 / MI)
    dual = torch.clamp(-z, min=0.0).amax(-1) / (1.0 + z.abs().amax(-1))
    return torch.maximum(torch.maximum(stat / scale_g, dual),
                         torch.maximum(viol / scale_d, comp / scale_g))


def _lower_sym(M):
    """The lower triangle mirrored onto the upper one."""
    return torch.tril(M) + torch.tril(M, -1).mT


def solve_fd_qp_plain(G, g, D, d, iters: int = 15):
    """Plain PyTorch version of the kernel (same inputs and outputs): the
    reference kernel's arithmetic in its order (see above)."""
    B = G.shape[0]
    eye = torch.eye(N, dtype=G.dtype, device=G.device)
    Greg = G + _DELTA * eye
    scale_g = 1.0 + g.abs().amax(-1)
    scale_d = 1.0 + d.abs().amax(-1)

    L0 = _cholesky(Greg)
    x = _chol_solve(L0, -g)
    s = torch.clamp(_slack(D, d, x), min=1.0)
    z = torch.ones_like(d)
    xb, zb = x, z
    kb = torch.full((B,), float("inf"), dtype=G.dtype, device=G.device)
    done = torch.zeros((B,), dtype=torch.bool, device=G.device)

    for _ in range(iters):
        r_d = _stationarity(g, G, x, D, z)
        r_p = _dot_rows(-d - s, D, x)
        mu = _sum_terms(s * z) * (1.0 / MI)
        rs = 1.0 / torch.clamp(s, min=_S_FLOOR)
        rz = 1.0 / torch.clamp(z, min=_S_FLOOR)
        DS = D * (z * rs)[:, :, None]
        M = Greg
        for k in range(MI):  # M = Greg + Dᵀ diag(z/s) D, lower triangle
            M = M + DS[:, k, :, None] * D[:, k, None, :]
        L, dsc = _scaled_cholesky(_lower_sym(M))

        def kkt_step(r_c):
            rhs = _dot_cols(-r_d, D, (r_c + z * r_p) * rs, -1.0)
            dx = _scaled_solve(L, dsc, rhs)
            ds = _dot_rows(r_p, D, dx)
            dz = -(r_c + z * ds) * rs
            return dx, ds, dz

        dx_a, ds_a, dz_a = kkt_step(s * z)
        alpha_p = _step_len_recip(rs, ds_a)[:, None]
        alpha_d = _step_len_recip(rz, dz_a)[:, None]
        mu_aff = _sum_terms((s + alpha_p * ds_a) * (z + alpha_d * dz_a)
                            ) * (1.0 / MI)
        ratio = mu_aff / torch.clamp(mu, min=1e-30)
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)

        dx, ds, dz = kkt_step(s * z + ds_a * dz_a - (sigma * mu)[:, None])
        alpha = torch.minimum(_step_len_recip(rs, ds),
                              _step_len_recip(rz, dz))[:, None]
        x_new, s_new, z_new = x + alpha * dx, s + alpha * ds, z + alpha * dz

        kkt_new = torch.maximum(
            r_d.abs().amax(-1) / scale_g,
            torch.maximum(r_p.abs().amax(-1) / scale_d, mu / scale_g),
        )
        better = (kkt_new < kb)[:, None]
        xb = torch.where(better, x, xb)
        zb = torch.where(better, z, zb)
        kb = torch.where(better[:, 0], kkt_new, kb)

        total = _sum_terms(x_new)
        for k in range(MI):
            total = total + s_new[:, k] + z_new[:, k]
        bad = ~torch.isfinite(total)
        keep = (~done & ~bad)[:, None]
        x = torch.where(keep, x_new, x)
        s = torch.where(keep, s_new, s)
        z = torch.where(keep, z_new, z)
        done = done | (kkt_new < _TOL) | bad

    # ---- endgame: honest residuals, best-of, active-set polish ----------
    k_last = _honest_kkt(G, g, D, d, x, z, scale_g, scale_d)
    k_best = _honest_kkt(G, g, D, d, xb, zb, scale_g, scale_d)
    take_last = k_last <= k_best
    x = torch.where(take_last[:, None], x, xb)
    z = torch.where(take_last[:, None], z, zb)
    kkt = torch.where(take_last, k_last, k_best)

    w = torch.where(z > _slack(D, d, x), 1.0, 0.0).to(G.dtype)
    Ew = D * w[:, :, None]
    GiEwT = _chol_solve(L0, Ew.mT)  # (B, N, MI): column k is G⁻¹ Ew[k]
    # K = Ew G⁻¹ Ewᵀ + diag(1 - w) + δI, lower triangle, term by term in j
    K = torch.diag_embed((1.0 - w) + _DELTA)
    for j in range(N):
        K = K + Ew[:, :, j, None] * GiEwT[:, None, j, :]
    LK, dscK = _scaled_cholesky(_lower_sym(K))

    xp = _chol_solve(L0, -g)
    lam = torch.zeros_like(d)
    for _ in range(4):
        r1 = _dot_rows(_dot_cols(-g, Ew, lam), G, xp, -1.0)
        r2 = _dot_rows(d, D, xp, -1.0) * w
        t = _chol_solve(L0, r1)
        dlam = _scaled_solve(LK, dscK, _dot_rows(r2, Ew, t, -1.0))
        xp = xp + _chol_solve(L0, _dot_cols(r1, Ew, dlam))
        lam = lam + dlam
    lam = lam * w
    k_pol = _honest_kkt(G, g, D, d, xp, lam, scale_g, scale_d)
    take_pol = k_pol < kkt  # False on a non-finite k_pol
    x = torch.where(take_pol[:, None], xp, x)
    z = torch.where(take_pol[:, None], lam, z)
    kkt = torch.where(take_pol, k_pol, kkt)
    s = torch.clamp(_slack(D, d, x), min=0.0)
    return x, s, z, kkt


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
