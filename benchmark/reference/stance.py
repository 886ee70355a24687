"""The standing-balance QPs of the ``fd_qp`` cells, worked out in float64
from the configuration's robot and controller alone.

The robot stands on four feet, each straight below its kinematic hip
(``hip_pos_m``) at the standing height h; the base is level and still,
and the traffic displaces it by delta from its target, the undisplaced
stance. For a level, still base the base frame is the world's, and the
balance controller's virtual-model law (controller_gains_gazebo.yaml)
asks for the base wrench

    f = Kp (-delta) + Kp_z (-delta_z) e_z + k g (m_base + sum_i m_i) e_z
    tau = c x (k g m_base e_z) + sum_i (o_i - c) x (k g m_i e_z)

with Kp the linear position gains (its z gain acting twice: once in the
base frame and once as the world-z term), k the share of gravity
compensated, c the base's centre of mass and o_i the virtual hips, where
the legs' masses sit; its velocity, orientation and feed-forward terms
vanish. The force distribution then seeks the ground-reaction forces x
(3 per foot) minimising (Ax - b)^T S (Ax - b) + 1/2 x^T W x, where A maps
the forces at the feet p_i to the wrench about the base origin,
A = [I I I I; [p_1]x ... [p_4]x], b = (f, tau), under the friction
pyramid of each foot: n.x_i >= f_min and mu n.x_i +- t_j.x_i >= 0, with n
the ground's normal, t_1 = n x e_y and t_2 = n x t_1 (both normalised).
"""

from __future__ import annotations

import torch

F64 = torch.float64


def _vec(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=F64, device=device)


def _cross_matrix(p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) with [p]x v = p x v."""
    zero = torch.zeros_like(p[..., 0])
    x, y, z = p.unbind(-1)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v)


def qps(cfg: dict, displacement, device) -> tuple:
    """(A (B,6,12), b (B,6), S (B,6), W (B,12), D (B,20,12), d (B,20)) in
    float64 of the standing-balance QPs whose bases are displaced by
    ``displacement`` (B, 3) metres."""
    robot, ctl = cfg["robot"], cfg["controller"]
    delta = torch.as_tensor(displacement, dtype=F64, device=device)
    B = delta.shape[0]

    g = robot["gravity_m_s2"] * ctl["gravity_percentage"]
    m_base = robot["base_mass_kg"]
    m_legs = _vec(robot["leg_mass_kg"], device)  # (4,)
    com = _vec(robot["com_in_base_m"], device)
    virtual_hips = _vec(robot["hip_offset_m"], device)  # (4, 3)
    e_z = _vec([0.0, 0.0, 1.0], device)

    kp = _vec(ctl["vmc_kp_lin"], device)
    force = kp * -delta + (kp[2] * -delta[:, 2])[:, None] * e_z
    force = force + g * (m_base + float(m_legs.sum())) * e_z
    torque = torch.linalg.cross(com, g * m_base * e_z) + torch.linalg.cross(
        virtual_hips - com, g * m_legs[:, None] * e_z).sum(0)
    b = torch.cat([force, torque.expand(B, 3)], dim=-1)

    feet = _vec(robot["hip_pos_m"], device) - cfg["stance_height_m"] * e_z
    A = torch.cat([torch.eye(3, dtype=F64, device=device).repeat(1, 4),
                   torch.cat(list(_cross_matrix(feet)), dim=-1)], dim=0)

    n = _unit(_vec(robot["ground_normal"], device))
    t1 = _unit(torch.linalg.cross(n, _vec([0.0, 1.0, 0.0], device)))
    t2 = _unit(torch.linalg.cross(n, t1))
    mu = ctl["friction_coeff"]
    pyramid = torch.stack([n, mu * n + t1, mu * n - t1, mu * n + t2,
                           mu * n - t2])  # (5, 3): the rows of one foot
    D = torch.block_diag(*[pyramid] * 4)  # (20, 12)
    d = _vec([ctl["min_normal_force_n"], 0.0, 0.0, 0.0, 0.0] * 4, device)

    S = _vec(ctl["s_weights"], device)
    W = torch.full((12,), ctl["w_regularizer"], dtype=F64, device=device)
    return (A.expand(B, 6, 12), b, S.expand(B, 6), W.expand(B, 12),
            D.expand(B, 20, 12), d.expand(B, 20))
