"""Batched massless-leg quadruped plant (≙ ``quadruped_locomotion_tpu/
rollout/simulator.py``).

The trunk is a 6-DoF rigid body; stance feet are pinned and their joint
torques map through the leg Jacobian to ground reactions on the trunk
(f = J⁻ᵀ(τ − τ_g), damped); swing legs integrate their own 3-DoF
dynamics in the hip frame; contact is unilateral in position.
Semi-implicit Euler at ``dt``. Every array carries leading scenario dims.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..model.dynamics import gravity_torques, leg_inverse_dynamics, leg_mass_matrix
from ..model.kinematics import forward_kinematics, inverse_kinematics, jacobians, mv
from ..ops import linalg3
from ..types import GRAVITY, BaseState, RobotModel, RobotState, TensorStruct, const
from ..utils.rotations import (
    cross, quat_exp, quat_inv_rotate, quat_mul, quat_normalize, quat_rotate,
)

SWING_SUBSTEPS = 4
CONTACT_TOL = 1e-3  # a foot touches within 1 mm of the surface


@dataclass
class SimState(TensorStruct):
    robot: RobotState
    feet_world: torch.Tensor  # (...,4,3) foot positions in world
    time: torch.Tensor  # (...)


def default_stance_state(model: RobotModel, height=0.4,
                         batch=(), dtype=torch.float32) -> SimState:
    """All-stance state with the feet below the kinematic hips, on the
    model's device. ``height`` is a float or a tensor of shape ``batch``
    (one standing height per scenario)."""
    dev = model.hip_pos.device
    h = torch.as_tensor(height, dtype=dtype, device=dev)
    zero = torch.zeros_like(h)
    pos = torch.stack([zero, zero, h], dim=-1)
    feet_base = model.hip_pos.to(dtype) - pos[..., None, :]
    q = inverse_kinematics(model, feet_base).expand(*batch, 4, 3).clone()
    base = BaseState.identity(batch, dev, dtype)
    base = base.replace(position=pos.expand(*batch, 3).clone())
    robot = RobotState.neutral(batch, dev, dtype).replace(base=base, q=q)
    feet_world = base.position[..., None, :] + quat_rotate(
        base.quaternion[..., None, :], feet_base)
    return SimState(robot=robot, feet_world=feet_world,
                    time=torch.zeros(batch, dtype=dtype, device=dev))


def contact_sensor(sim: SimState, ground_height=0.0) -> torch.Tensor:
    """(...,4) measured foot contact (pinned legs always report touch)."""
    return sim.robot.support | (sim.feet_world[..., 2] <= ground_height + CONTACT_TOL)


def foot_heights(sim: SimState, terrain_height_fn=None) -> torch.Tensor:
    """Clearance of each foot above the terrain (flat ground by default):
    (..., 4)."""
    z = sim.feet_world[..., 2]
    if terrain_height_fn is None:
        return z
    return z - terrain_height_fn(sim.feet_world[..., :2])


def _integrate_swing_legs(model, q, qd, tau, g_base, dt):
    """Substepped semi-implicit integration of the 3-DoF leg dynamics with
    implicit viscous joint damping: (M + h·b·I) q̇' = M q̇ + h·(τ − C q̇ − G)."""
    h = dt / SWING_SUBSTEPS
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    for _ in range(SWING_SUBSTEPS):
        bias = leg_inverse_dynamics(model, q, qd, torch.zeros_like(qd), g_base)
        m = leg_mass_matrix(model, q)
        qd = linalg3.solve3(m + h * model.joint_damping * eye3,
                            mv(m, qd) + h * (tau - bias))
        q = q + h * qd
    return q, qd


def step(
    model: RobotModel,
    sim: SimState,
    tau: torch.Tensor,  # (...,4,3) commanded joint torques
    dt: float,
    support: torch.Tensor | None = None,  # (...,4) commanded contact state
    ground_height=0.0,
) -> SimState:
    """One physics step."""
    robot = sim.robot
    dtype = tau.dtype
    if support is None:
        support = robot.support
    # Unilateral pinning: a commanded-support leg carries load only once
    # its foot touches; a leg commanded into swing is released.
    touching = sim.feet_world[..., 2] <= ground_height + CONTACT_TOL
    support = support & (robot.support | touching)
    base = robot.base
    # Unilateral reach: a foot almost a full leg length from its hip
    # breaks contact instead of running the joint solve through the
    # straight-knee singularity.
    reach = torch.sqrt(model.d**2 + (model.l1 + model.l2) ** 2).to(dtype)
    hips_world = base.position[..., None, :] + quat_rotate(
        base.quaternion[..., None, :], model.hip_pos.to(dtype))
    extension = torch.linalg.norm(sim.feet_world - hips_world, dim=-1)
    support = support & (extension < 0.995 * reach)
    g_world = const((0.0, 0.0, -GRAVITY), tau)
    g_base = quat_inv_rotate(base.quaternion, g_world)

    feet_base = quat_inv_rotate(base.quaternion[..., None, :],
                                sim.feet_world - base.position[..., None, :])
    j = jacobians(model, robot.q)
    tau_g = gravity_torques(model, robot.q, g_base)

    # --- stance path: torques → ground reaction on the trunk, damped least
    # squares f ≈ (J Jᵀ + λ²I)⁻¹ J t solving Jᵀ f = t
    dls = 1e-4 * torch.eye(3, dtype=dtype, device=tau.device)
    f_contact = linalg3.solve3(j @ j.mT + dls, mv(j, tau - tau_g))
    grf_base = -f_contact
    m = support.to(dtype)[..., None]
    total_force_world = (
        quat_rotate(base.quaternion, (grf_base * m).sum(-2))
        + model.total_mass * g_world
    )
    total_torque_base = (cross(feet_base, grf_base) * m).sum(-2)

    # --- trunk integration (semi-implicit Euler)
    inertia = model.base_inertia.to(dtype)
    w = base.angular_velocity
    ang_mom_rate = total_torque_base - cross(w, mv(inertia, w))
    angvel_new = w + dt * linalg3.solve3(inertia, ang_mom_rate)
    linvel_new = base.linear_velocity + dt * total_force_world / model.total_mass
    pos_new = base.position + dt * linvel_new
    quat_new = quat_normalize(quat_mul(base.quaternion, quat_exp(dt * angvel_new)))
    base_new = BaseState(position=pos_new, quaternion=quat_new,
                         linear_velocity=linvel_new,
                         angular_velocity=angvel_new)

    # --- stance legs: joints follow the pinned feet
    qn = quat_new[..., None, :]
    feet_base_new = quat_inv_rotate(qn, sim.feet_world - pos_new[..., None, :])
    q_stance = inverse_kinematics(model, feet_base_new)
    v_feet_base = -cross(angvel_new[..., None, :], feet_base_new) - (
        quat_inv_rotate(qn, linvel_new[..., None, :].expand_as(feet_base_new)))
    j_new = jacobians(model, q_stance)
    qd_stance = linalg3.solve3(j_new.mT @ j_new + dls, mv(j_new.mT, v_feet_base))

    # --- swing legs: articulated 3-DoF dynamics
    q_swing, qd_swing = _integrate_swing_legs(model, robot.q, robot.qd, tau,
                                              g_base, dt)

    sup = support[..., None]
    q_new = torch.where(sup, q_stance, q_swing)
    qd_new = torch.where(sup, qd_stance, qd_swing)

    # swing feet move with the leg; stance feet stay pinned at the surface
    ground = (torch.as_tensor(ground_height, dtype=dtype, device=tau.device)
              if isinstance(ground_height, torch.Tensor)
              else const(float(ground_height), tau))
    feet_pinned = torch.cat([
        sim.feet_world[..., :2],
        torch.maximum(sim.feet_world[..., 2:], ground[..., None]),
    ], dim=-1)
    feet_world_new = torch.where(
        sup, feet_pinned,
        pos_new[..., None, :] + quat_rotate(qn, forward_kinematics(model, q_new)),
    )
    robot_new = robot.replace(base=base_new, q=q_new, qd=qd_new, tau=tau,
                              support=support)
    return SimState(robot=robot_new, feet_world=feet_world_new,
                    time=sim.time + dt)
