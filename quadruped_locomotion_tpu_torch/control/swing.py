"""Swing-leg computed-torque control (≙ ``quadruped_locomotion_tpu/control/
swing.py``): τ = Jᵀ(Kp·e_pos + Kd·e_vel) + InverseDynamics(q, q̇, ½·q̈_des),
with q̈_des from the planned foot acceleration through damped
differential kinematics; and the joint-space PD / PID + gravity
compensation of frozen and joint-mode legs."""

from __future__ import annotations

import torch
from torch.func import jvp

from ..model.dynamics import gravity_torques, leg_inverse_dynamics
from ..model.kinematics import forward_kinematics, jacobians, mv
from ..ops import linalg3
from ..types import GRAVITY, RobotModel, RobotState, SwingGains, const
from ..utils.rotations import quat_inv_rotate


def _gravity_in_base(state: RobotState, like: torch.Tensor) -> torch.Tensor:
    return quat_inv_rotate(state.base.quaternion,
                           const((0.0, 0.0, -GRAVITY), like))


def swing_torques(
    model: RobotModel,
    gains: SwingGains,
    state: RobotState,
    p_des_base: torch.Tensor,  # (...,4,3) desired foot positions, base frame
    v_des_base: torch.Tensor,  # (...,4,3)
    a_des_base: torch.Tensor,  # (...,4,3)
) -> torch.Tensor:
    """Computed-torque swing control for every leg: (...,4,3). Callers
    mask by the support state (stance legs use the QP torques)."""
    g_base = _gravity_in_base(state, p_des_base)
    q, qd = state.q, state.qd
    p = forward_kinematics(model, q)
    j = jacobians(model, q)
    force = gains.kp * (p_des_base - p) + gains.kd * (v_des_base - mv(j, qd))

    # q̈_des = J⁺ (a_des − J̇ q̇), damped so a leg near the straight-knee
    # singularity degrades to zero feedforward instead of NaN torques.
    # Every leg's J depends on its own q only, so one jvp over the whole
    # batch gives each leg's J̇ q̇.
    _, jdot_qd = jvp(lambda qq: mv(jacobians(model, qq), qd), (q,), (qd,))
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    jjt = j @ j.mT + 1e-4 * eye
    qdd_des = mv(j.mT, linalg3.solve3(jjt, a_des_base - jdot_qd))
    tau_id = leg_inverse_dynamics(model, q, qd, 0.5 * qdd_des, g_base)
    return mv(j.mT, force) + tau_id


def joint_pd_gravity_torques(
    model: RobotModel,
    state: RobotState,
    q_des: torch.Tensor,  # (...,4,3)
    qd_des: torch.Tensor,  # (...,4,3)
    kp: float = 300.0,
    kd: float = 3.0,
) -> torch.Tensor:
    """Joint-space PD + gravity compensation (the reference's per-joint
    fallback mode, PID gains 300/0.01/3)."""
    tau_g = gravity_torques(model, state.q, _gravity_in_base(state, q_des))
    return kp * (q_des - state.q) + kd * (qd_des - state.qd) + tau_g


def joint_pid_gravity_torques(
    model: RobotModel,
    state: RobotState,
    q_des: torch.Tensor,  # (...,4,3)
    qd_des: torch.Tensor,  # (...,4,3)
    integral: torch.Tensor,  # (...,4,3) accumulated ∫e dt, carried by the caller
    dt: float,
    kp: float = 300.0,
    ki: float = 0.01,
    kd: float = 3.0,
    i_max: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint-space PID + gravity compensation for joint-mode legs (the
    reference's per-joint PID, gains 300/0.01/3). Returns (torques
    (...,4,3), new integral (...,4,3)); the integral is clamped to
    ±``i_max``/ki against windup."""
    e = q_des - state.q
    bound = i_max / max(ki, 1e-12)
    integral2 = torch.clamp(integral + e * dt, -bound, bound)
    tau_g = gravity_torques(model, state.q, _gravity_in_base(state, q_des))
    tau = kp * e + ki * integral2 + kd * (qd_des - state.qd) + tau_g
    return tau, integral2
