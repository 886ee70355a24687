"""Batched leg dynamics: gravity torques, mass matrix, inverse dynamics
(≙ ``quadruped_locomotion_tpu/model/dynamics.py``).

Each leg is a fixed-base 3-DoF chain in its hip frame. As in the
reference, everything derives from the link CoM kinematics by automatic
differentiation: ``torch.func.grad`` of the potential for G(q),
``torch.func.jacfwd`` of the CoM positions for M(q) and of M(q) for the
Christoffel (Coriolis) term. The per-leg functions are written for one
leg and mapped over the flattened batch with ``torch.func.vmap``.

Gravity vectors are accelerations in the base frame, e.g. (0, 0, -9.8)
rotated into it.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.func import grad, jacfwd, vmap

from ..ops import linalg3
from ..types import RobotModel, const
from .kinematics import leg_com_positions_hip, link_rotations_hip, mv


def _potential(model: RobotModel, q_leg, g_hip):
    """U(q) = -Σ m_i gᵀ c_i(q) of one leg (q_leg (3,), g_hip (3,))."""
    coms = leg_com_positions_hip(model, q_leg)
    return -(model.link_mass.to(q_leg.dtype) @ (coms @ g_hip))


def _mass_matrix(model: RobotModel, q_leg):
    """M(q) = Σ_k m_k Jv_kᵀ Jv_k + Jw_kᵀ (R_k I_k R_kᵀ) Jw_k for one leg."""
    dtype = q_leg.dtype
    jv = jacfwd(partial(leg_com_positions_hip, model))(q_leg)  # (3,3,3)
    rots = link_rotations_hip(model, q_leg)
    z = const((0.0, 0.0, 1.0), q_leg)
    # joint axes in the hip frame; link k sees joints j <= k
    axes = torch.stack([z, mv(rots[1], z), mv(rots[2], z)], dim=-1)
    m = torch.zeros((3, 3), dtype=dtype, device=q_leg.device)
    for k in range(3):
        jw_k = axes * (torch.arange(3, device=q_leg.device) <= k).to(dtype)
        inertia = rots[k] @ model.link_inertia[k].to(dtype) @ rots[k].T
        m = m + model.link_mass[k] * (jv[k].T @ jv[k]) + jw_k.T @ inertia @ jw_k
    return m


def _inverse_dynamics(model: RobotModel, q_leg, qd_leg, qdd_leg, g_hip):
    dm = jacfwd(partial(_mass_matrix, model))(q_leg)  # (3,3,3): dM/dq_k
    m = _mass_matrix(model, q_leg)
    # c_i = Σ_{j,k} (dM_ij/dq_k - ½ dM_jk/dq_i) qd_j qd_k
    coriolis = torch.einsum("ijk,j,k->i", dm, qd_leg, qd_leg) - 0.5 * (
        torch.einsum("jki,j,k->i", dm, qd_leg, qd_leg))
    g = grad(partial(_potential, model))(q_leg, g_hip)
    return m @ qdd_leg + coriolis + g


def _per_leg(fn, *arrays):
    """Map a one-leg function over all leading dims of (..., 3) arrays."""
    lead = arrays[0].shape[:-1]
    flat = [a.expand(lead + a.shape[-1:]).reshape(-1, a.shape[-1])
            for a in arrays]
    out = vmap(fn)(*flat)
    return out.reshape(lead + out.shape[1:])


def _gravity_in_hips(model: RobotModel, gravity_in_base, dtype):
    """(..., 3) base-frame gravity -> (..., 4, 3) per-leg hip frames."""
    return mv(model.hip_rot.transpose(-1, -2).to(dtype),
              gravity_in_base.unsqueeze(-2))


def gravity_torques(model: RobotModel, q: torch.Tensor,
                    gravity_in_base: torch.Tensor) -> torch.Tensor:
    """Joint torques holding every leg against gravity, G(q) = ∇_q U:
    q (..., 4, 3), gravity_in_base (..., 3) -> (..., 4, 3)."""
    g_hip = _gravity_in_hips(model, gravity_in_base, q.dtype)
    return _per_leg(grad(partial(_potential, model)), q, g_hip)


def leg_mass_matrix(model: RobotModel, q_leg: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrices: q_leg (..., 3) -> (..., 3, 3)."""
    return _per_leg(partial(_mass_matrix, model), q_leg)


def leg_inverse_dynamics(
    model: RobotModel,
    q: torch.Tensor,
    qd: torch.Tensor,
    qdd: torch.Tensor,
    gravity_in_base: torch.Tensor,
) -> torch.Tensor:
    """τ = M(q) q̈ + C(q, q̇) q̇ + G(q) for every leg: (..., 4, 3) joint
    arrays and (..., 3) base-frame gravity -> (..., 4, 3)."""
    g_hip = _gravity_in_hips(model, gravity_in_base, q.dtype)
    return _per_leg(partial(_inverse_dynamics, model), q, qd, qdd, g_hip)


def inverse_dynamics(model: RobotModel, q: torch.Tensor, qd: torch.Tensor,
                     qdd: torch.Tensor,
                     gravity_in_base: torch.Tensor) -> torch.Tensor:
    """All legs' inverse dynamics (the JAX package's name for
    :func:`leg_inverse_dynamics`): (..., 4, 3) torques."""
    return leg_inverse_dynamics(model, q, qd, qdd, gravity_in_base)


def leg_forward_dynamics(model: RobotModel, q_leg: torch.Tensor,
                         qd_leg: torch.Tensor, tau_leg: torch.Tensor,
                         gravity_in_base: torch.Tensor, leg) -> torch.Tensor:
    """q̈ = M⁻¹(τ − C q̇ − G) of one leg (index ``leg``): (..., 3) joint
    arrays and (..., 3) base-frame gravity -> (..., 3)."""
    hip_rot = model.hip_rot[leg].to(q_leg.dtype)
    g_hip = mv(hip_rot.transpose(-1, -2), gravity_in_base)
    bias = _per_leg(partial(_inverse_dynamics, model), q_leg, qd_leg,
                    torch.zeros_like(qd_leg), g_hip)
    m = leg_mass_matrix(model, q_leg)
    return linalg3.solve3(m, tau_leg - bias)
