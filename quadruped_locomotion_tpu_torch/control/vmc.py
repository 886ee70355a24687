"""Virtual-model balance controller (≙ ``quadruped_locomotion_tpu/control/
vmc.py``): the desired base wrench from pose/twist errors plus gravity
compensation, in the base frame, batched over leading dims."""

from __future__ import annotations

from ..types import GRAVITY, BaseTarget, RobotModel, RobotState, VmcGains, const
from ..utils.rotations import (
    cross, quat_conj, quat_inv_rotate, quat_log, quat_mul,
)


def compute_virtual_wrench(
    model: RobotModel,
    gains: VmcGains,
    state: RobotState,
    target: BaseTarget,
):
    """Returns (virtual_force, virtual_torque), each (..., 3), base frame."""
    q_act = state.base.quaternion
    vec = lambda *v: const(v, q_act)  # noqa: E731

    # errors: position/velocity in world, orientation as a base-frame
    # rotation vector -log(q_t⁻¹ ⊗ q_a), angular velocity in base frame
    pos_err_world = target.position - state.base.position
    ori_err = -quat_log(quat_mul(quat_conj(target.quaternion), q_act))
    vel_err_world = target.linear_velocity - state.base.linear_velocity
    angvel_err_base = (
        quat_inv_rotate(q_act, target.angular_velocity)
        - state.base.angular_velocity
    )

    # gravity compensation: torso + per-leg point masses at the virtual hips
    g_base = quat_inv_rotate(q_act, vec(0.0, 0.0, -GRAVITY))
    k = gains.gravity_percentage
    f_torso = -k * model.base_mass * g_base
    f_legs = -k * model.leg_mass[:, None] * g_base[..., None, :]  # (...,4,3)
    grav_force = f_torso + f_legs.sum(-2)
    grav_torque = cross(model.com_in_base, f_torso) + cross(
        model.hip_offset - model.com_in_base, f_legs).sum(-2)

    # virtual force, with the extra world-z-only feedback terms
    ff_lin = target.linear_velocity * vec(1.0, 1.0, 0.0)
    zmask = vec(0.0, 0.0, 1.0)
    f_zfb_world = gains.kp_lin * (zmask * pos_err_world)
    f_zdb_world = gains.kd_lin * (zmask * vel_err_world)
    virtual_force = (
        gains.kp_lin * quat_inv_rotate(q_act, pos_err_world)
        + gains.kd_lin * quat_inv_rotate(q_act, vel_err_world)
        + gains.kff_lin * quat_inv_rotate(q_act, ff_lin)
        + grav_force
        + quat_inv_rotate(q_act, f_zfb_world)
        + quat_inv_rotate(q_act, f_zdb_world)
    )

    ff_ang = target.angular_velocity * zmask
    virtual_torque = (
        gains.kp_ang * ori_err
        + gains.kd_ang * angvel_err_base
        + quat_inv_rotate(q_act, gains.kff_ang * ff_ang)
        + grav_torque
    )
    return virtual_force, virtual_torque
