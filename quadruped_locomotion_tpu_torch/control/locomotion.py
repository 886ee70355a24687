"""Locomotion controller tick split at the QP solve (≙
``quadruped_locomotion_tpu/control/locomotion.py``): stance legs get VMC +
force-distribution torques, swing legs computed-torque control, all
clamped to ±300 N·m. A batched rollout runs :func:`locomotion_prepare`
for every scenario, ONE batched QP solve, then :func:`locomotion_finish`;
:func:`locomotion_update` composes the three with the generic QP, as the
reference's single-scenario tick does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..model.kinematics import forward_kinematics, mv
from ..ops import qp
from ..ops.fd_qp_kernel import form_quadratic
from ..ops.qp import QpSolution
from ..types import (
    BaseTarget, CfdParams, RobotModel, RobotState, SwingGains, TensorStruct,
    VmcGains,
)
from ..utils.rotations import quat_inv_rotate
from .balance_controller import BalanceDiagnostics
from .force_distribution import ForceDistributionResult, build_qp, stance_torques
from .swing import swing_torques
from .vmc import compute_virtual_wrench


@dataclass
class ControllerParams(TensorStruct):
    vmc: VmcGains
    cfd: CfdParams
    swing: SwingGains

    @classmethod
    def defaults(cls, device=None) -> "ControllerParams":
        return cls(vmc=VmcGains.gazebo_defaults(device),
                   cfd=CfdParams.defaults(device),
                   swing=SwingGains.defaults(device))


class LocomotionContext(NamedTuple):
    """Everything a control tick computes before the QP solve."""

    A: torch.Tensor  # (...,6,12) wrench map
    b: torch.Tensor  # (...,6) virtual wrench
    S: torch.Tensor  # (...,6) diag weights
    W: torch.Tensor  # (...,12) diag regularizer
    D: torch.Tensor  # (...,20,12) inequality rows
    d: torch.Tensor  # (...,20)
    # The FORMED quadratic G = 2AᵀSA + diag(W), g = −2AᵀSb: exactly one
    # float32 formation per tick, which the solver consumes and telemetry
    # records. A second formation rounds differently and moves the optimum
    # 0.1-0.5 N along the W = 1e-4 flat valley.
    G: torch.Tensor  # (...,12,12)
    g: torch.Tensor  # (...,12)
    virtual_force: torch.Tensor  # (...,3)
    virtual_torque: torch.Tensor  # (...,3)
    tau_swing: torch.Tensor  # (...,4,3) swing computed-torque output


def locomotion_prepare(
    model: RobotModel,
    params: ControllerParams,
    state: RobotState,
    target: BaseTarget,
    swing_pos_world: torch.Tensor,  # (...,4,3) swing-foot references
    swing_vel_world: torch.Tensor,
    swing_acc_world: torch.Tensor,
) -> LocomotionContext:
    """Stage 1: VMC wrench + QP assembly and formation + swing torques."""
    vf, vt = compute_virtual_wrench(model, params.vmc, state, target)
    feet = forward_kinematics(model, state.q)
    A, b, S, W, D, d = build_qp(model, params.cfd, state, vf, vt, feet)
    G, g = form_quadratic(A, S, W, b)

    # world → base swing references: plain rotated spline derivatives,
    # without base-twist compensation (the reference's semantics).
    q = state.base.quaternion[..., None, :]
    p_des = quat_inv_rotate(q, swing_pos_world - state.base.position[..., None, :])
    v_des = quat_inv_rotate(q, swing_vel_world)
    a_des = quat_inv_rotate(q, swing_acc_world)
    tau_swing = swing_torques(model, params.swing, state, p_des, v_des, a_des)
    return LocomotionContext(
        A=A, b=b, S=S, W=W, D=D, d=d, G=G, g=g,
        virtual_force=vf, virtual_torque=vt, tau_swing=tau_swing,
    )


def locomotion_finish(
    model: RobotModel,
    params: ControllerParams,
    state: RobotState,
    ctx: LocomotionContext,
    sol: QpSolution,
):
    """Stage 2: QP solution → stance torques, swing merge, ±300 clamp.
    Returns (torques (...,4,3), BalanceDiagnostics)."""
    x = sol.x * state.support.to(sol.x.dtype).repeat_interleave(3, dim=-1)
    grf = x.reshape(x.shape[:-1] + (4, 3))
    dist = ForceDistributionResult(
        contact_forces=-grf,
        ground_reaction=grf,
        qp_solution=sol,
        virtual_wrench_realized=mv(ctx.A, sol.x),
    )
    lim = model.torque_limit
    tau_stance = torch.clamp(
        stance_torques(model, state, dist.contact_forces), -lim, lim)
    tau = torch.where(state.support[..., None], tau_stance, ctx.tau_swing)
    tau = torch.clamp(tau, -lim, lim)
    return tau, BalanceDiagnostics(
        virtual_force=ctx.virtual_force,
        virtual_torque=ctx.virtual_torque,
        distribution=dist,
    )


def locomotion_update(
    model: RobotModel,
    params: ControllerParams,
    state: RobotState,
    target: BaseTarget,
    swing_pos_world: torch.Tensor,  # (...,4,3) swing-foot references
    swing_vel_world: torch.Tensor,
    swing_acc_world: torch.Tensor,
    qp_iters: int = 15,
):
    """One control tick: prepare → the generic IPM ``ops.qp.solve_qp``
    over the leading dims → finish. Returns (torques (...,4,3),
    BalanceDiagnostics)."""
    ctx = locomotion_prepare(model, params, state, target, swing_pos_world,
                             swing_vel_world, swing_acc_world)
    sol = qp.solve_qp(ctx.G, ctx.g, ctx.D, ctx.d, iters=qp_iters)
    return locomotion_finish(model, params, state, ctx, sol)
