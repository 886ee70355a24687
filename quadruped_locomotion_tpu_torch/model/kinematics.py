"""Batched analytic kinematics of the 3-DoF simpledog leg (≙
``quadruped_locomotion_tpu/model/kinematics.py``).

    p_hip(q) = Rz(q1) · Rx(-π/2) · Rz(q2) · ([l1,0,d] + Rz(q3)·[l2,0,0])
    p_base   = hip_pos + R_hip · p_hip

Joint arrays are (..., 4, 3): any leading batch dims, then legs, then
joints; the per-leg hip poses of the model broadcast over the batch.
"""

from __future__ import annotations

import math

import torch

from ..ops import linalg3
from ..types import RobotModel, const
from ..utils.rotations import cross, rotz, wrap_angle


def _rx_neg90(like: torch.Tensor) -> torch.Tensor:
    """Rx(-π/2): (x, y, z) -> (x, z, -y)."""
    return const(((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0)), like)


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _l1_0_d(model: RobotModel, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([model.l1, torch.zeros_like(model.l1), model.d]).to(
        like.dtype)


def leg_fk_hip(model: RobotModel, q_leg: torch.Tensor) -> torch.Tensor:
    """Foot position in the hip frame, q_leg (..., 3) -> (..., 3)."""
    q1, q2, q3 = q_leg.unbind(-1)
    knee = torch.stack([model.l1 + model.l2 * torch.cos(q3),
                        model.l2 * torch.sin(q3),
                        model.d * torch.ones_like(q3)], dim=-1)
    return mv(rotz(q1), mv(_rx_neg90(q_leg), mv(rotz(q2), knee)))


def forward_kinematics(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """All-feet FK: q (..., 4, 3) -> foot positions in base (..., 4, 3)."""
    return model.hip_pos + mv(model.hip_rot, leg_fk_hip(model, q))


def jacobians(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """Closed-form translational Jacobians d(p_base)/dq: (..., 4, 3, 3)."""
    q1, q2 = q[..., 0], q[..., 1]
    r1 = rotz(q1) @ _rx_neg90(q)
    r2 = r1 @ rotz(q2)
    z = const((0.0, 0.0, 1.0), q)
    p = leg_fk_hip(model, q)
    axis2 = mv(r1, z)
    axis3 = mv(r2, z)
    o3 = mv(r2, _l1_0_d(model, q))
    j1 = cross(z, p)
    j2 = cross(axis2, p)
    j3 = cross(axis3, p - o3)
    return model.hip_rot @ torch.stack([j1, j2, j3], dim=-1)


def inverse_kinematics_branches(
    model: RobotModel, feet_in_base: torch.Tensor
) -> torch.Tensor:
    """All four analytic IK branches: (..., 4, 3) -> (..., 4 legs, 4
    branches, 3). Branches 0=OUT_LEFT, 1=IN_RIGHT, 2=IN_LEFT, 3=OUT_RIGHT;
    out-of-reach targets clamp cos θ3 to the workspace boundary."""
    dtype = feet_in_base.dtype
    d = model.d.to(dtype)
    l1 = model.l1.to(dtype)
    l2 = model.l2.to(dtype)
    p_hip = mv(model.hip_rot.transpose(-1, -2).to(dtype),
               feet_in_base - model.hip_pos.to(dtype))
    px, py, pz = p_hip.unbind(-1)

    cos_t3 = (l2 * l2 + l1 * l1 - (px * px + py * py + pz * pz - d * d)) / (
        2.0 * l1 * l2
    )
    t3 = torch.acos(torch.clamp(cos_t3, -1.0, 1.0))
    q3_a = math.pi - t3  # branches 0, 1
    q3_b = -math.pi + t3  # branches 2, 3

    r = torch.sqrt(torch.clamp(px * px + py * py - d * d, min=1e-12))
    alpha = torch.atan2(py, px)
    beta1 = torch.atan2(d.expand_as(r), r)
    beta2 = torch.atan2(-d.expand_as(r), -r)

    def branch_pair(q3):
        b = torch.atan2(l2 * torch.sin(q3), l1 + l2 * torch.cos(q3))
        q1_l = wrap_angle(alpha - beta1)
        a_l = torch.atan2(pz, -r)
        q2_l = wrap_angle(torch.where(a_l > 0, a_l - b - math.pi,
                                      a_l - b + math.pi))
        q1_r = wrap_angle(alpha + beta2)
        a_r = torch.atan2(pz, r)
        q2_r = wrap_angle(a_r - b + math.pi)
        return (torch.stack([q1_l, q2_l, q3], dim=-1),
                torch.stack([q1_r, q2_r, q3], dim=-1))

    sol0, sol1 = branch_pair(q3_a)
    sol2, sol3 = branch_pair(q3_b)
    return torch.stack([sol0, sol1, sol2, sol3], dim=-2)


def inverse_kinematics(
    model: RobotModel, feet_in_base: torch.Tensor,
    branch: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-legs IK with per-leg branch selection (default: the model's
    limb configuration): (..., 4, 3) -> (..., 4, 3)."""
    sols = inverse_kinematics_branches(model, feet_in_base)
    if branch is None:
        branch = model.ik_branch
    idx = branch.long().reshape(4, 1, 1).expand(sols.shape[:-2] + (1, 3))
    return torch.gather(sols, -2, idx).squeeze(-2)


def joint_velocities_from_foot_velocities(model: RobotModel, q: torch.Tensor,
                                          v_feet: torch.Tensor) -> torch.Tensor:
    """Differential IK: solve J q̇ = v per leg, v_feet (..., 4, 3) in the
    base frame -> q̇ (..., 4, 3)."""
    return linalg3.solve3(jacobians(model, q), v_feet)


def foot_velocities(model: RobotModel, q: torch.Tensor, qd: torch.Tensor):
    """Foot velocities in base frame from joint velocities: (..., 4, 3)."""
    return mv(jacobians(model, q), qd)


def leg_com_positions_hip(model: RobotModel, q_leg: torch.Tensor):
    """Per-link CoM positions of a leg in its hip frame: (..., 3 links, 3)."""
    q1, q2, q3 = q_leg.unbind(-1)
    com = model.link_com.to(q_leg.dtype)
    r1j = rotz(q1)
    r2 = r1j @ _rx_neg90(q_leg) @ rotz(q2)
    r3 = r2 @ rotz(q3)
    o3 = mv(r2, _l1_0_d(model, q_leg))
    c1 = mv(r1j, com[0])
    c2 = mv(r2, com[1])
    c3 = o3 + mv(r3, com[2])
    return torch.stack([c1, c2, c3], dim=-2)


def link_rotations_hip(model: RobotModel, q_leg: torch.Tensor):
    """Per-link orientations in the hip frame: (..., 3 links, 3, 3)."""
    q1, q2, q3 = q_leg.unbind(-1)
    r1j = rotz(q1)
    r2 = r1j @ _rx_neg90(q_leg) @ rotz(q2)
    r3 = r2 @ rotz(q3)
    return torch.stack([r1j, r2, r3], dim=-3)
