"""Contact-force distribution: the friction-cone QP and the torque map
(≙ ``quadruped_locomotion_tpu/control/force_distribution.py``).

Per scenario, with x the stacked ground-reaction forces (3 per leg),

    min (Ax − b)ᵀ S (Ax − b) + xᵀ W x
    s.t. n_i·f_i ≥ f_min,   μ n_i·f_i ± t_{1,2}·f_i ≥ 0   (stance legs)

The problem is always 12 variables × 20 rows: swing legs are masked out
by zeroing their A/D entries and relaxing their rows (d = -1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..model.dynamics import gravity_torques
from ..model.kinematics import forward_kinematics, jacobians, mv
from ..ops import fd_qp_kernel, qp
from ..ops.qp import QpSolution
from ..types import GRAVITY, CfdParams, RobotModel, RobotState, const
from ..utils import logging as qlog
from ..utils.rotations import cross, quat_inv_rotate, skew


class ForceDistributionResult(NamedTuple):
    contact_forces: torch.Tensor  # (...,4,3) force the LEG exerts (= -x)
    ground_reaction: torch.Tensor  # (...,4,3) ground-reaction force x
    qp_solution: QpSolution
    virtual_wrench_realized: torch.Tensor  # (...,6) A @ x


def build_qp(
    model: RobotModel,
    params: CfdParams,
    state: RobotState,
    virtual_force: torch.Tensor,
    virtual_torque: torch.Tensor,
    feet_in_base: torch.Tensor | None = None,
):
    """Assemble (A (...,6,12), b (...,6), S (...,6), W (...,12),
    D (...,20,12), d (...,20)) for a batch of scenarios."""
    dtype, dev = virtual_force.dtype, virtual_force.device
    batch = virtual_force.shape[:-1]
    if feet_in_base is None:
        feet_in_base = forward_kinematics(model, state.q)
    mask = state.support.to(dtype)  # (...,4)
    m33 = mask[..., :, None, None]  # (...,4,1,1)

    # A: top identity blocks, bottom skew(r_i); swing columns zeroed
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    a_top = torch.cat((eye3 * m33).unbind(-3), dim=-1)
    a_bot = torch.cat((skew(feet_in_base) * m33).unbind(-3), dim=-1)
    A = torch.cat([a_top, a_bot], dim=-2)
    b = torch.cat([virtual_force, virtual_torque], dim=-1)
    S = params.s_weights.to(dtype).expand(batch + (6,))
    W = params.w_regularizer.to(dtype).expand(batch + (12,))

    # Surface normals and tangentials in base frame; the first tangential
    # lies in the base XZ-plane (t1 = n × ŷ_base), anchored to the body.
    n_base = quat_inv_rotate(state.base.quaternion[..., None, :],
                             state.surface_normal)  # (...,4,3)
    y_base = const((0.0, 1.0, 0.0), virtual_force)
    t1 = cross(n_base, y_base)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-9)
    t2 = cross(n_base, t1)
    t2 = t2 / torch.clamp(torch.linalg.norm(t2, dim=-1, keepdim=True), min=1e-9)

    mu = params.friction_coeff
    rows = torch.stack(
        [n_base, mu * n_base + t1, mu * n_base - t1,
         mu * n_base + t2, mu * n_base - t2], dim=-2,
    ) * m33  # (...,4 legs,5 rows,3)
    # block-diagonal placement: leg i's 5 rows act on columns 3i..3i+2
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    D = (rows[..., :, :, None, :] * eye4[:, None, :, None]).reshape(
        batch + (20, 12))
    sup = state.support[..., :, None]
    off = const(-1.0, virtual_force)
    d_min = torch.where(sup, params.min_normal_force.to(dtype), off)
    d_cone = torch.where(sup, const(0.0, virtual_force), off)
    d = torch.cat([d_min, d_cone.expand(batch + (4, 4))], dim=-1).reshape(
        batch + (20,))
    return A, b, S, W, D, d


def _kernel_solution(x, s, z, kkt, iters) -> QpSolution:
    B = x.shape[0]
    return QpSolution(
        x=x, z=z, y=x.new_zeros((B, 0)), s=s,
        iterations=torch.full((B,), iters, dtype=torch.int32, device=x.device),
        kkt_error=kkt,
    )


# backend -> (module, its weighted least-squares solve, its formed solve);
# the names are looked up at each call
_QP_BACKENDS = {
    "auto": (fd_qp_kernel, "solve_weighted_ls_fd_qp", "solve_fd_qp"),
    "kernel": (fd_qp_kernel, "solve_weighted_ls_fd_qp", "solve_fd_qp"),
    "plain": (fd_qp_kernel, "solve_weighted_ls_fd_qp_plain",
              "solve_fd_qp_plain"),
    "generic": (qp, "solve_weighted_ls_qp", "solve_qp"),
}


def _qp_solve(backend: str, formed: bool, t: torch.Tensor):
    """The solve that ``backend`` names (:func:`solve_fd_qp_batched`), of
    the formed quadratic (G, g, D, d) or else of the weighted
    least-squares form (A, S, b, W, D, d), taking ``iters=`` and returning
    a :class:`QpSolution`. Raises ValueError on an unknown name, and for
    "kernel" unless ``t`` is a CUDA tensor."""
    if backend not in _QP_BACKENDS:
        raise ValueError(f"unknown QP backend {backend!r}")
    if backend == "kernel" and t.device.type != "cuda":
        raise ValueError(f"backend={backend!r} needs CUDA tensors, got {t.device}")
    module, ls, form = _QP_BACKENDS[backend]
    solve = getattr(module, form if formed else ls)
    if module is qp:
        return solve
    return lambda *args, iters: _kernel_solution(*solve(*args, iters=iters),
                                                 iters)


def solve_fd_qp_batched(
    A: torch.Tensor,  # (B,6,12)
    b: torch.Tensor,  # (B,6)
    S: torch.Tensor,  # (B,6)
    W: torch.Tensor,  # (B,12)
    D: torch.Tensor,  # (B,20,12)
    d: torch.Tensor,  # (B,20)
    iters: int = 15,
    backend: str = "auto",
    load_factors: torch.Tensor | None = None,  # (B,4)
    support: torch.Tensor | None = None,  # (B,4) bool, required with factors
) -> QpSolution:
    """ONE solver dispatch for a whole batch of force-distribution QPs in
    the weighted least-squares form.

    ``backend``: "auto" goes through ``fd_qp_kernel.solve_weighted_ls_fd_qp``
    (the CUDA kernel for CUDA tensors, its plain version for CPU tensors);
    "kernel" requires CUDA tensors and raises otherwise; "plain" runs the
    plain version on any device; "generic" runs the generic batched IPM
    ``ops.qp.solve_weighted_ls_qp`` (the yardstick of the headline's
    cross-check).

    ``load_factors`` (+ ``support``) engages the reference's leg-load
    double solve by elimination, as :func:`distribute` does: stance legs
    with factor < 1 are pinned to factor × (first solution), their wrench
    moves to the right-hand side, their columns and rows are masked out,
    and the batch is solved again on the same backend (two kernel
    launches on CUDA).

    The whole call is the span ``qp.entry``.
    """
    with qlog.span("qp.entry"):
        solve = _qp_solve(backend, False, A)
        sol = solve(A, S, b, W, D, d, iters=iters)
        if load_factors is None:
            return sol
        if support is None:
            raise ValueError("load_factors requires the support mask")
        A2, b2, D2, d2, pinned, x_pin = eliminate_pinned(
            A, b, D, d, sol.x, load_factors, support)
        sol2 = solve(A2, S, b2, W, D2, d2, iters=iters)
        return sol2._replace(
            x=combine_pinned(sol2.x, x_pin, pinned, support))


def eliminate_pinned(A, b, D, d, x_first, load_factors, support):
    """The second problem of the load-factor double solve (same math as
    :func:`distribute`): stance legs with factor < 1 are pinned to
    factor × ``x_first``; their wrench moves to the right-hand side and
    their columns and rows are masked out. Returns (A2, b2, D2, d2,
    pinned (B,4), x_pin (B,12))."""
    dtype = x_first.dtype
    lf = load_factors.to(dtype)
    pinned = support & (lf < 1.0)  # (B,4)
    pin12 = pinned.repeat_interleave(3, dim=-1)  # (B,12)
    x_pin = torch.where(pin12, x_first * lf.repeat_interleave(3, dim=-1),
                        torch.zeros_like(x_first))
    keep12 = (~pin12).to(dtype)
    rows = pinned.repeat_interleave(5, dim=-1)  # (B,20) pinned legs' rows
    A2 = A * keep12[:, None, :]
    D2 = D * keep12[:, None, :] * (~rows).to(dtype)[:, :, None]
    d2 = torch.where(rows, torch.full_like(d, -1.0), d)
    return A2, b - mv(A, x_pin), D2, d2, pinned, x_pin


def combine_pinned(x_second, x_pin, pinned, support):
    """Pinned legs from ``x_pin``, the other stance legs from the second
    solve, swing legs 0."""
    free = (support & ~pinned).to(x_second.dtype).repeat_interleave(3, dim=-1)
    return torch.where(pinned.repeat_interleave(3, dim=-1), x_pin,
                       x_second * free)


def solve_formed_qp_batched(
    G: torch.Tensor,  # (B,12,12) formed quadratic
    g: torch.Tensor,  # (B,12)
    D: torch.Tensor,  # (B,20,12)
    d: torch.Tensor,  # (B,20)
    iters: int = 15,
    backend: str = "auto",
) -> QpSolution:
    """ONE solver dispatch for a whole batch of force-distribution QPs on
    an already-formed quadratic (see ``LocomotionContext.G/g``).

    ``backend`` as in :func:`solve_fd_qp_batched` ("generic" is
    ``ops.qp.solve_qp``).
    """
    return _qp_solve(backend, True, G)(
        G.contiguous(), g.contiguous(), D.contiguous(), d.contiguous(),
        iters=iters)


def distribute(
    model: RobotModel,
    params: CfdParams,
    state: RobotState,
    virtual_force: torch.Tensor,
    virtual_torque: torch.Tensor,
    feet_in_base: torch.Tensor | None = None,
    iters: int = 20,
    load_factors: torch.Tensor | None = None,
    warm: tuple[torch.Tensor, torch.Tensor] | None = None,
    polish: str = "full",
) -> ForceDistributionResult:
    """Force distribution of a batch of scenarios through the generic QP
    (≙ the reference's ``distribute``); every input carries the same
    leading dims.

    ``load_factors`` (..., 4) engages the double-solve leg unloading:
    stance legs with factor < 1 are pinned to factor × (first solution)
    and the remaining legs re-optimised. ``warm``/``polish`` are passed
    to the first solve (see :func:`..ops.qp.solve_qp`).
    """
    if feet_in_base is None:
        feet_in_base = forward_kinematics(model, state.q)
    A, b, S, W, D, d = build_qp(model, params, state, virtual_force,
                                virtual_torque, feet_in_base)
    sol = qp.solve_weighted_ls_qp(A, S, b, W, D, d, iters=iters, warm=warm,
                                  polish=polish)
    dtype = sol.x.dtype
    x = sol.x * state.support.to(dtype).repeat_interleave(3, dim=-1)
    realized_extra = 0.0

    if load_factors is not None:
        lf = load_factors.to(dtype)
        pinned = state.support & (lf < 1.0)  # (...,4)
        x_pin = x.reshape(x.shape[:-1] + (4, 3)) * lf[..., None]
        f_pin = torch.where(pinned[..., None], x_pin, torch.zeros_like(x_pin))
        wrench_pin = torch.cat([f_pin.sum(-2),
                                cross(feet_in_base, f_pin).sum(-2)], dim=-1)
        state2 = state.replace(support=state.support & ~pinned)
        A2, _, _, _, D2, d2 = build_qp(model, params, state2, virtual_force,
                                       virtual_torque, feet_in_base)
        sol2 = qp.solve_weighted_ls_qp(A2, S, b - wrench_pin, W, D2, d2,
                                       iters=iters)
        x2 = sol2.x * state2.support.to(dtype).repeat_interleave(3, dim=-1)
        x = torch.where(pinned.repeat_interleave(3, dim=-1),
                        x_pin.reshape(x.shape), x2)
        sol, A, realized_extra = sol2, A2, wrench_pin

    grf = x.reshape(x.shape[:-1] + (4, 3))
    return ForceDistributionResult(
        contact_forces=-grf,
        ground_reaction=grf,
        qp_solution=sol,
        virtual_wrench_realized=mv(A, sol.x) + realized_extra,
    )


def stance_torques(
    model: RobotModel,
    state: RobotState,
    contact_forces: torch.Tensor,
) -> torch.Tensor:
    """τ_i = J_iᵀ f_i + τ_gravity(q_i) for every leg: (...,4,3)."""
    g_world = const((0.0, 0.0, -GRAVITY), contact_forces)
    g_base = quat_inv_rotate(state.base.quaternion, g_world)
    j = jacobians(model, state.q)
    tau_f = torch.einsum("...lji,...lj->...li", j, contact_forces)
    return tau_f + gravity_torques(model, state.q, g_base)
