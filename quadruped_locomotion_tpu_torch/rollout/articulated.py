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

:func:`step` is the entry point. On CUDA tensors it is one launch of the
hand-written kernel ``csrc/articulated_step.cu`` (built with ``nvcc`` at
first use, bound with ``ctypes``; float32 only, other dtypes raise): a
warp per scenario, the same step with the Jacobians and bias
accelerations in closed form from each leg's chain and the contact system
solved through the Cholesky factor of M. On the CPU it is
:func:`step_plain`, the step above in plain PyTorch on any device and
dtype, which the tests hold against the JAX package and which the card's
tests and ``chip_smoke.py`` run in float64, by name, to hold the kernel
against.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.func import jacfwd, jvp, vmap

from ..model.kinematics import (
    forward_kinematics, leg_com_positions_hip, link_rotations_hip, mv,
)
from ..types import GRAVITY, BaseState, RobotModel, const
from ..utils.cuda_build import MODEL_FLOATS, Arg, CudaKernel, pack_model
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
# A foot beyond this share of its leg's reach is not pinned.
REACH_SHARE = 0.995
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
    g_world = const((0.0, 0.0, -GRAVITY), q)

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
    mask = support_cmd & (pinned | touching) & (extension < REACH_SHARE * reach)
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
        tangential = const((True, True, False) * 4, mask3b)
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


def step_plain(
    model: RobotModel,
    sim: SimState,
    tau: torch.Tensor,  # (B,4,3) commanded joint torques
    dt: float,
    support: torch.Tensor | None = None,  # (B,4) commanded contact state
    ground_height=0.0,
    substeps: int = SUBSTEPS,
    friction_mu: float | None = None,
) -> SimState:
    """:func:`step` in plain PyTorch on any device and dtype: the JAX
    package's algorithm (autodiff through the chart, masked KKT solves)."""
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


# ---------------------------------------------------------------------------
# The kernel: csrc/articulated_step.cu, bound as the QP's
# (utils/cuda_build.CudaKernel): nvcc into build/ once per source hash,
# ctypes, a C entry that returns cudaGetLastError().
# ---------------------------------------------------------------------------

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "articulated_step.cu"


class PlantConsts(ctypes.Structure):
    """The kernel's ``PlantConsts``, passed by value."""

    _fields_ = [("h", ctypes.c_float), ("substeps", ctypes.c_int),
                ("gravity", ctypes.c_float), ("contact_tol", ctypes.c_float),
                ("kd", ctypes.c_float), ("kp", ctypes.c_float),
                ("compliance", ctypes.c_float),
                ("release_force", ctypes.c_float),
                ("reach_share", ctypes.c_float), ("mu", ctypes.c_float)]


def plant_consts(dt: float, substeps: int,
                 friction_mu: float | None) -> PlantConsts:
    """The plant's constants above and one step's numbers, for the kernel."""
    return PlantConsts(
        h=dt / substeps, substeps=substeps, gravity=GRAVITY,
        contact_tol=CONTACT_TOL, kd=2.0 / BAUMGARTE_TAU,
        kp=1.0 / BAUMGARTE_TAU ** 2, compliance=CONTACT_COMPLIANCE,
        release_force=RELEASE_FORCE, reach_share=REACH_SHARE,
        mu=0.0 if friction_mu is None else friction_mu)


_STATE = (Arg("position", (3,)), Arg("quaternion", (4,)),
          Arg("linear_velocity", (3,)), Arg("angular_velocity", (3,)),
          Arg("q", (4, 3)), Arg("qd", (4, 3)),
          Arg("pinned", (4,), torch.bool), Arg("anchors", (4, 3)))
# articulated_step(model, the state, tau, support, ground_height, the next
# state, B, PlantConsts, friction, stream); counted under plant.*
KERNEL = CudaKernel(
    SOURCE, "articulated_step", "plant",
    inputs=(Arg("model", (MODEL_FLOATS,), batched=False), *_STATE,
            Arg("tau", (4, 3)), Arg("support", (4,), torch.bool),
            Arg("ground_height", (4,))),
    outputs=_STATE, scalars=(PlantConsts, ctypes.c_int))


def step_flops(substeps: int = SUBSTEPS, friction: bool = False) -> int:
    """Floating-point operations of one scenario's step, counted from the
    algorithm (a multiply-add is 2, a division, square root or reciprocal
    square root 1; comparisons and selects are not counted). Per internal
    substep: the 17 points' kinematics (each leg's chain, joint axes and
    origins; each point's position); the Jacobian columns (the base's
    angular columns of every point, a cross product each, and each joint's
    column of the points it moves); the 13 bodies' world inertias
    R I Rᵀ; M's lower entries, a body term (m jv_a·jv_b + jw_a·I jw_b, 31
    flop) for each body that moves both coordinates; the bodies' forces
    and torques and h's projections; the points' velocities and bias
    accelerations; M's Cholesky factor; L⁻¹ of the 12 contact columns and
    of τ − h; the Gram matrix; each contact solve (the 12×12 Cholesky
    factor and two triangular solves: stick and re-solve, and the Coulomb
    solve with friction, which also adds the sliding feet's forces); v̇;
    the Baumgarte right-hand side; the integration. Then the closing FK of
    the 4 feet. What the kernel's lanes compute beyond that (a Jacobian
    column again for each entry of M that reads it) is not counted, so
    the bound it feeds is the algorithm's, not the kernel's."""
    nv, nc, pts = 18, 12, 17
    kinematics = 4 * 273 + 16 * 42 + 48
    columns = pts * 3 * 9 + 4 * (1 + 2 + 3 + 3) * 12
    inertias = 13 * 84
    pairs = (21 * 13  # two base coordinates: all 13 bodies
             + 6 * 4 * (3 + 2 + 1)  # a base and a joint coordinate
             + 4 * sum(3 - k for j in range(3) for k in range(j, 3)))
    mass = pairs * 31
    bias = 13 * 57 + (6 * 13 + 4 * (3 + 2 + 1)) * 12
    motion = pts * 24 + 4 * (1 + 2 + 3 + 3) * 51 + 4 * (1 + 2 + 3) * 12
    cholesky = nv ** 3 // 3 + nv
    forward = (nc + 1) * nv * nv
    gram = (nc * (nc + 1) // 2 + nc) * 2 * nv
    solve = nc ** 3 // 3 + nc + 2 * nc * nc + nc
    solves = (3 if friction else 2) * solve + (2 * nc * nc if friction else 0)
    accel = 2 * nv * nc + nv * nv
    rest = nc * 8 + 140
    per_substep = (kinematics + columns + inertias + mass + bias + motion
                   + cholesky + forward + gram + solves + accel + rest)
    return substeps * per_substep + 4 * 100


def step_bytes(batch: int) -> int:
    """Bytes one step must move: the model once, each scenario's state,
    torques, commanded support and ground heights read once and its next
    state written once (float32; pin and support flags a byte each)."""
    floats_in = 3 + 4 + 3 + 3 + 12 + 12 + 12 + 12 + 4
    floats_out = 3 + 4 + 3 + 3 + 12 + 12 + 12
    return 4 * MODEL_FLOATS + batch * (4 * (floats_in + floats_out) + 8 + 4)


def kernel_inputs(model: RobotModel, sim: SimState, tau: torch.Tensor,
                  support: torch.Tensor | None = None,
                  ground_height=0.0) -> dict:
    """The kernel's inputs by name, in its argument order: the packed
    model, the state's tensors, the torques, the commanded support and the
    ground height under each foot, made contiguous (a no-op where they
    are)."""
    robot, B = sim.robot, tau.shape[0]
    if support is None:
        support = robot.support
    if isinstance(ground_height, torch.Tensor):
        gz = ground_height.to(tau.dtype).expand(B, 4)
    else:  # a fill, no copy from the host
        gz = torch.full((B, 4), float(ground_height), dtype=tau.dtype,
                        device=tau.device)
    base = robot.base
    ins = {"model": pack_model(model), "position": base.position,
           "quaternion": base.quaternion, "linear_velocity":
           base.linear_velocity, "angular_velocity": base.angular_velocity,
           "q": robot.q, "qd": robot.qd, "pinned": robot.support,
           "anchors": sim.feet_world, "tau": tau, "support": support,
           "ground_height": gz}
    return {k: t.contiguous() for k, t in ins.items()}


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
    the Coulomb cone and lets feet slide; None is rigid stick.

    CUDA tensors go to the kernel (:data:`KERNEL`, one launch on the
    current stream over :func:`kernel_inputs`; it raises on anything but
    float32), CPU tensors to :func:`step_plain`, which callers also name
    for the plain step on the card."""
    if not tau.is_cuda:
        return step_plain(model, sim, tau, dt, support, ground_height,
                          substeps, friction_mu)
    ins = kernel_inputs(model, sim, tau, support, ground_height)
    (position, quaternion, linear_velocity, angular_velocity, q, qd, pinned,
     anchors) = KERNEL(*ins.values(), plant_consts(dt, substeps, friction_mu),
                       friction_mu is not None)
    base = BaseState(position=position, quaternion=quaternion,
                     linear_velocity=linear_velocity,
                     angular_velocity=angular_velocity)
    robot = sim.robot.replace(base=base, q=q, qd=qd, tau=tau, support=pinned)
    return SimState(robot=robot, feet_world=anchors, time=sim.time + dt)


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
