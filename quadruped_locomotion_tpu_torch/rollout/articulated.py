"""Batched fully-coupled 18-DoF floating-base plant (≙
``quadruped_locomotion_tpu/rollout/articulated.py``).

One rigid-body system per scenario,

    M(q) v̇ + h(q, v) = Sᵀ τ + J_cᵀ λ,     J_c v̇ = b_c (pinned feet)

with generalised velocity v = [v_base (world), ω_base (body), q̇ (12)].

* The 17 link CoM positions and rotations are one closed-form
  kinematics function of local coordinates ξ = (δp, φ, δq) ∈ R¹⁸ with
  the base chart R = R₀·exp(φ̂) centred at the current quaternion; at
  φ = 0 the chart has ξ̇ = v and ξ̈ = v̇, so forward-mode autodiff
  (``torch.func.jacfwd`` and a nested ``torch.func.jvp``, mapped over
  the scenarios with ``torch.func.vmap``) gives the exact Jacobians and
  the zero-acceleration (bias) link accelerations.
* M = Σ_k m_k Jv_kᵀJv_k + Jω_kᵀ (R I Rᵀ) Jω_k over the 13 bodies, and
  h = Σ_k Jv_kᵀ m_k (a_k⁰ − g) + Jω_kᵀ (I_w ω̇_k⁰ + ω_k × I_w ω_k), both
  assembled for all bodies at once.
* Stance feet are 3-way position constraints in one static-shape masked
  30×30 KKT system (batched ``torch.linalg.solve_ex``, no host sync),
  Baumgarte-stabilised towards the stored anchor, and re-solved once
  after releasing feet whose normal force comes out negative; with
  ``friction_mu`` a third solve lets feet outside the Coulomb cone slide.

Mass bookkeeping as in the reference: the trunk keeps the controller's
total mass minus the explicit link masses and loses the lumped legs'
parallel-axis inertia. Every state tensor carries one leading scenario
axis B; ``SimState.feet_world`` holds the pinned feet's anchors.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, jvp, vmap

from ..model.kinematics import (
    forward_kinematics, leg_com_positions_hip, link_rotations_hip, mv,
)
from ..types import GRAVITY, BaseState, RobotModel
from ..utils.rotations import (
    cross, matrix_from_quat, quat_exp, quat_mul, quat_normalize, skew,
)
from .simulator import CONTACT_TOL, SimState

# Baumgarte stabilisation time constant [s]: critically damped
# ë = -(2/τ)ė - (1/τ²)e towards the anchor.
BAUMGARTE_TAU = 0.005
# Constraint compliance: keeps the KKT system full rank when a leg
# straightens through the knee singularity.
CONTACT_COMPLIANCE = 1e-6
# A pinned foot whose solved normal force is below this is released.
RELEASE_FORCE = 0.0
SUBSTEPS = 2


def _rodrigues_local(phi: torch.Tensor) -> torch.Tensor:
    """exp(φ̂) as a θ²-polynomial: exact derivatives of all orders at
    φ = 0, the only point it is evaluated at (the chart centre)."""
    t2 = (phi * phi).sum(-1)[..., None, None]
    a = 1.0 - t2 / 6.0 + t2 * t2 / 120.0  # sinθ/θ
    b = 0.5 - t2 / 24.0 + t2 * t2 / 720.0  # (1−cosθ)/θ²
    k = skew(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + a * k + b * (k @ k)


def _unskew(a: torch.Tensor) -> torch.Tensor:
    """Inverse of skew() for (..., 3, 3) (anti-symmetrises first)."""
    return 0.5 * torch.stack(
        [a[..., 2, 1] - a[..., 1, 2],
         a[..., 0, 2] - a[..., 2, 0],
         a[..., 1, 0] - a[..., 0, 1]],
        dim=-1,
    )


def base_dynamic_params(model: RobotModel):
    """(m_base, I_base) of the trunk body alone: the controller's total
    mass minus the explicit link masses, and the lumped inertia without
    the legs' point-mass parallel-axis terms."""
    m_base = model.total_mass - 4.0 * model.link_mass.sum()
    inertia = model.base_inertia
    eye = torch.eye(3, dtype=inertia.dtype, device=inertia.device)
    for i in range(4):
        r = model.hip_offset[i]
        inertia = inertia - model.leg_mass[i] * (
            torch.dot(r, r) * eye - torch.outer(r, r))
    return m_base, inertia


def _link_kinematics(model: RobotModel, p0, rot0, q0, xi):
    """World pose of the 17 bodies and the feet of ONE scenario as a
    function of the local coordinates ξ = [δp (3), φ (3), δq (12)].
    Returns a dict: coms (4,3,3), rots (4,3,3,3), feet (4,3),
    base_com (3,), base_rot (3,3)."""
    dtype = xi.dtype
    dp, phi, dq = xi[:3], xi[3:6], xi[6:].reshape(4, 3)
    rwb = rot0 @ _rodrigues_local(phi)
    p = p0 + dp
    q = q0 + dq
    coms_h = leg_com_positions_hip(model, q)  # (4,3,3) hip frames
    rots_h = link_rotations_hip(model, q)  # (4,3,3,3)
    hp = model.hip_pos.to(dtype)
    hr = model.hip_rot.to(dtype)
    coms_b = hp[:, None, :] + coms_h @ hr.mT  # (4,3,3) base frame
    coms_w = p + coms_b @ rwb.T
    rots_w = torch.einsum("ab,lbc,lkcd->lkad", rwb, hr, rots_h)
    feet = p + forward_kinematics(model, q) @ rwb.T
    base_com = p + rwb @ model.com_in_base.to(dtype)
    return {"coms": coms_w, "rots": rots_w, "feet": feet,
            "base_com": base_com, "base_rot": rwb}


def _kinematics_and_derivatives(model: RobotModel, p0, rot0, q0, v):
    """Per scenario: kinematics at ξ = 0, its Jacobian (leaves with a
    trailing (18,) axis) and the second directional derivative along v
    (the zero-acceleration link accelerations)."""

    def fn(xi):
        return _link_kinematics(model, p0, rot0, q0, xi)

    def with_aux(xi):
        out = fn(xi)
        return out, out

    xi0 = torch.zeros(18, dtype=v.dtype, device=v.device)
    jac, kin = jacfwd(with_aux, has_aux=True)(xi0)
    _, kin_ddot = jvp(lambda xi: jvp(fn, (xi,), (v,))[1], (xi0,), (v,))
    return kin, jac, kin_ddot


def _generalized_velocity(base: BaseState, qd: torch.Tensor) -> torch.Tensor:
    return torch.cat([base.linear_velocity, base.angular_velocity,
                      qd.reshape(qd.shape[:-2] + (12,))], dim=-1)


def _dynamics_terms(model: RobotModel, base: BaseState, q, qd):
    """(M (B,18,18), h (B,18), kin, jac, kin_dot, kin_ddot) at the
    current state of every scenario."""
    dtype = q.dtype
    B = q.shape[0]
    rot0 = matrix_from_quat(base.quaternion)
    v = _generalized_velocity(base, qd)
    kin, jac, kin_ddot = vmap(
        lambda p0, r0, q0, vv: _kinematics_and_derivatives(model, p0, r0, q0, vv)
    )(base.position, rot0, q, v)
    kin_dot = {k: torch.einsum("b...j,bj->b...", j, v) for k, j in jac.items()}

    m_base, i_base = base_dynamic_params(model)
    g_world = torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=q.device)

    # the 13 bodies side by side: trunk, then 4 legs × 3 links
    def rots(tree):
        return torch.cat([tree["base_rot"][:, None],
                          tree["rots"].flatten(1, 2)], dim=1)

    def coms(tree):
        return torch.cat([tree["base_com"][:, None],
                          tree["coms"].flatten(1, 2)], dim=1)

    mass = torch.cat([m_base.reshape(1), model.link_mass.repeat(4)]).to(dtype)
    inertia_local = torch.cat([i_base[None], model.link_inertia.repeat(4, 1, 1)]
                              ).to(dtype)  # (13,3,3)
    jv, rot_jac = coms(jac), rots(jac)  # (B,13,3,18), (B,13,3,3,18)
    rot, rot_dot, rot_ddot = rots(kin), rots(kin_dot), rots(kin_ddot)
    a_bias = coms(kin_ddot)

    # ω-Jacobian columns: unskew(∂R/∂ξ_j Rᵀ)
    jw = _unskew(torch.einsum("...abj,...cb->...jac", rot_jac, rot)).mT
    i_w = rot @ inertia_local @ rot.mT
    omega = _unskew(rot_dot @ rot.mT)
    omega_dot = _unskew(rot_ddot @ rot.mT)  # Ṙ·Ṙᵀ is symmetric and drops
    m_c = (mass[:, None, None] * jv.mT) @ jv + jw.mT @ i_w @ jw
    force = mass[:, None] * (a_bias - g_world)
    torque = mv(i_w, omega_dot) + cross(omega, mv(i_w, omega))
    h_c = mv(jv.mT, force) + mv(jw.mT, torque)
    return m_c.sum(1), h_c.sum(1), kin, jac, kin_dot, kin_ddot


def _constrained_accel(m_mat, h_vec, tau_gen, j_c, b_c, mask3):
    """Masked 30×30 KKT solve: M v̇ − Aᵀλ = τ_gen − h;  A v̇ + ελ = b_c.
    Inactive rows get A-row = 0 and compliance 1, hence λ = 0."""
    a = torch.where(mask3[..., None], j_c, torch.zeros_like(j_c))  # (B,12,18)
    comp = torch.where(mask3, torch.full_like(b_c, CONTACT_COMPLIANCE),
                       torch.ones_like(b_c))
    kkt = torch.cat([torch.cat([m_mat, -a.mT], dim=-1),
                     torch.cat([a, torch.diag_embed(comp)], dim=-1)], dim=-2)
    rhs = torch.cat([tau_gen - h_vec,
                     torch.where(mask3, b_c, torch.zeros_like(b_c))], dim=-1)
    sol = torch.linalg.solve_ex(kkt, rhs.unsqueeze(-1))[0].squeeze(-1)
    return sol[:, :18], sol[:, 18:].reshape(-1, 4, 3)


def _on_surface(feet, gz4):
    return torch.cat([feet[..., :2], gz4[..., None]], dim=-1)


def _substep(model: RobotModel, carry, tau, h, support_cmd, gz4, mu=None):
    """One semi-implicit Euler substep of the constrained dynamics.

    With ``mu`` (a float or None), pinned feet whose stick solution
    needs |λ_t| > μ·λ_n slide: a third masked solve keeps only their
    normal row and applies kinetic friction μ·λ_n against the slip
    velocity as an external force. ``None`` is the rigid-stick model.
    """
    base, q, qd, pinned, anchors = carry
    dtype = q.dtype
    B = q.shape[0]

    m_mat, h_vec, kin, jac, kin_dot, kin_ddot = _dynamics_terms(
        model, base, q, qd)
    feet = kin["feet"]

    # contact gating (the massless plant's unilateral rules)
    touching = feet[..., 2] <= gz4 + CONTACT_TOL
    reach = torch.sqrt(model.d ** 2 + (model.l1 + model.l2) ** 2).to(dtype)
    hips_world = base.position[:, None, :] + model.hip_pos.to(dtype) @ \
        kin["base_rot"].mT
    extension = torch.linalg.norm(feet - hips_world, dim=-1)
    mask = support_cmd & (pinned | touching) & (extension < 0.995 * reach)
    # newly pinned feet anchor where they touched, snapped onto the surface
    anchors = torch.where((mask & ~pinned)[..., None], _on_surface(feet, gz4),
                          anchors)

    j_c = jac["feet"].reshape(B, 12, 18)
    kd = 2.0 / BAUMGARTE_TAU
    kp = 1.0 / BAUMGARTE_TAU ** 2
    b_c = (-kin_ddot["feet"] - kd * kin_dot["feet"]
           - kp * (feet - anchors)).reshape(B, 12)
    tau_gen = torch.cat([torch.zeros((B, 6), dtype=dtype, device=q.device),
                         (tau - model.joint_damping * qd).reshape(B, 12)], dim=-1)

    mask3 = mask.repeat_interleave(3, dim=-1)
    vdot, lam = _constrained_accel(m_mat, h_vec, tau_gen, j_c, b_c, mask3)
    # unilateral: release feet that pull (negative world-z contact force)
    mask2 = mask & (lam[..., 2] >= RELEASE_FORCE)
    mask3b = mask2.repeat_interleave(3, dim=-1)
    vdot, lam = _constrained_accel(m_mat, h_vec, tau_gen, j_c, b_c, mask3b)
    lam = torch.where(mask2[..., None], lam, torch.zeros_like(lam))

    if mu is not None:
        # Coulomb-cone check on the stick solution
        lam_t = torch.linalg.norm(lam[..., :2], dim=-1)
        lam_n = torch.clamp(lam[..., 2], min=0.0)
        slipping = mask2 & (lam_t > mu * lam_n + 1e-9)
        # kinetic friction opposes the slip velocity; at stick-break onset
        # it keeps the direction stick was applying (force-continuous)
        vt = kin_dot["feet"][..., :2]
        vt_n = torch.linalg.norm(vt, dim=-1, keepdim=True)
        dir_f = torch.where(
            vt_n > 1e-3,
            -vt / torch.clamp(vt_n, min=1e-9),
            lam[..., :2] / torch.clamp(lam_t, min=1e-9)[..., None],
        )
        f_t = mu * lam_n[..., None] * dir_f  # (B,4,2) world tangential
        f_ext = torch.cat([f_t, torch.zeros_like(f_t[..., :1])], dim=-1) \
            * slipping[..., None].to(dtype)
        tangential = torch.tensor([True, True, False], device=q.device).repeat(4)
        mask3c = mask3b & ~(slipping.repeat_interleave(3, dim=-1) & tangential)
        tau_gen_f = tau_gen + mv(j_c.mT, f_ext.reshape(B, 12))
        vdot, lam3 = _constrained_accel(m_mat, h_vec, tau_gen_f, j_c, b_c,
                                        mask3c)
        lam = torch.where(slipping[..., None],
                          torch.cat([f_t, lam3[..., 2:3]], dim=-1), lam3)
        lam = torch.where(mask2[..., None], lam, torch.zeros_like(lam))
        # a sliding foot's anchor follows it
        anchors = torch.where(slipping[..., None], _on_surface(feet, gz4),
                              anchors)

    # semi-implicit Euler
    v_new = _generalized_velocity(base, qd) + h * vdot
    pos_new = base.position + h * v_new[:, :3]
    quat_new = quat_normalize(quat_mul(base.quaternion,
                                       quat_exp(h * v_new[:, 3:6])))
    qd_new = v_new[:, 6:].reshape(B, 4, 3)
    base_new = BaseState(position=pos_new, quaternion=quat_new,
                         linear_velocity=v_new[:, :3],
                         angular_velocity=v_new[:, 3:6])
    return (base_new, q + h * qd_new, qd_new, mask2, anchors), lam


def step(
    model: RobotModel,
    sim: SimState,
    tau: torch.Tensor,  # (B,4,3) commanded joint torques
    dt: float,
    support: torch.Tensor | None = None,  # (B,4) commanded contact state
    ground_height=0.0,
    substeps: int = SUBSTEPS,
    friction_mu: float | None = None,
) -> SimState:
    """One coupled-physics step of every scenario (a drop-in for the
    massless ``simulator.step``). ``sim.feet_world`` carries the pinned
    feet's anchors (swing feet are FK positions); ``sim.robot.support``
    is the realised pin state. ``friction_mu`` bounds contact forces by
    the Coulomb cone and lets feet slide; None is rigid stick."""
    robot = sim.robot
    dtype = tau.dtype
    B = tau.shape[0]
    if support is None:
        support = robot.support
    gz4 = torch.as_tensor(ground_height, dtype=dtype,
                          device=tau.device).expand(B, 4)
    h = dt / substeps

    carry = (robot.base, robot.q, robot.qd, robot.support, sim.feet_world)
    for _ in range(substeps):
        carry, _ = _substep(model, carry, tau, h, support, gz4, mu=friction_mu)
    base, q, qd, pinned, anchors = carry

    rot = matrix_from_quat(base.quaternion)
    feet_fk = base.position[:, None, :] + forward_kinematics(model, q) @ rot.mT
    feet_world = torch.where(pinned[..., None], anchors, feet_fk)
    robot_new = robot.replace(base=base, q=q, qd=qd, tau=tau, support=pinned)
    return SimState(robot=robot_new, feet_world=feet_world, time=sim.time + dt)


def mass_matrix(model: RobotModel, base: BaseState, q: torch.Tensor) -> torch.Tensor:
    """(B,18,18) floating-base joint-space inertia matrices."""
    return _dynamics_terms(model, base, q, torch.zeros_like(q))[0]


def bias_forces(model: RobotModel, base: BaseState, q: torch.Tensor,
                qd: torch.Tensor) -> torch.Tensor:
    """(B,18) velocity-product + gravity generalised forces."""
    return _dynamics_terms(model, base, q, qd)[1]


def unconstrained_accel(model: RobotModel, base: BaseState, q, qd, tau):
    """(B,18) v̇ with no contacts (free flight)."""
    m_mat, h_vec = _dynamics_terms(model, base, q, qd)[:2]
    B = q.shape[0]
    tau_gen = torch.cat([torch.zeros((B, 6), dtype=q.dtype, device=q.device),
                         (tau - model.joint_damping * qd).reshape(B, 12)], dim=-1)
    return torch.linalg.solve_ex(m_mat, (tau_gen - h_vec).unsqueeze(-1))[0][..., 0]
