"""Swing-leg computed-torque control (≙ ``quadruped_locomotion_tpu/control/
swing.py``): τ = Jᵀ(Kp·e_pos + Kd·e_vel) + InverseDynamics(q, q̇, ½·q̈_des),
with q̈_des from the planned foot acceleration through damped
differential kinematics; and the joint-space PD / PID + gravity
compensation of frozen and joint-mode legs.

:func:`swing_torques` is the entry point. On CUDA tensors it is one launch
of the hand-written kernel ``csrc/swing_torques.cu`` (built with ``nvcc`` at
first use, bound with ``ctypes``; float32 only, other dtypes raise): a
thread per leg, J̇q̇ in closed form and the inverse dynamics by recursive
Newton–Euler. On the CPU it is :func:`swing_torques_plain`, the law in
plain PyTorch on any device and dtype (autodiff, as the JAX package), which
the tests hold against the JAX package and which the card's tests and
``chip_smoke.py`` run in float64, by name, to hold the kernel against."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.func import jvp

from ..model.dynamics import gravity_torques, leg_inverse_dynamics
from ..model.kinematics import forward_kinematics, jacobians, mv
from ..ops import linalg3
from ..types import GRAVITY, RobotModel, RobotState, SwingGains, const
from ..utils.cuda_build import MODEL_FLOATS, Arg, CudaKernel, pack_model
from ..utils.rotations import quat_inv_rotate

# the damped differential kinematics: J Jᵀ + DAMPING·I, and the share of
# q̈_des fed forward through the inverse dynamics
DAMPING = 1e-4
FEEDFORWARD = 0.5


def _gravity_in_base(state: RobotState, like: torch.Tensor) -> torch.Tensor:
    return quat_inv_rotate(state.base.quaternion,
                           const((0.0, 0.0, -GRAVITY), like))


def swing_torques_plain(
    model: RobotModel,
    gains: SwingGains,
    state: RobotState,
    p_des_base: torch.Tensor,  # (...,4,3) desired foot positions, base frame
    v_des_base: torch.Tensor,  # (...,4,3)
    a_des_base: torch.Tensor,  # (...,4,3)
) -> torch.Tensor:
    """:func:`swing_torques` in plain PyTorch on any device and dtype: the
    JAX package's algorithm (a jvp of the Jacobians, the inverse dynamics
    of ``model/dynamics.py``)."""
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
    jjt = j @ j.mT + DAMPING * eye
    qdd_des = mv(j.mT, linalg3.solve3(jjt, a_des_base - jdot_qd))
    tau_id = leg_inverse_dynamics(model, q, qd, FEEDFORWARD * qdd_des, g_base)
    return mv(j.mT, force) + tau_id


# ---------------------------------------------------------------------------
# The kernel: csrc/swing_torques.cu, bound as the plant's
# (utils/cuda_build.CudaKernel): nvcc into build/ once per source hash,
# ctypes, a C entry that returns cudaGetLastError().
# ---------------------------------------------------------------------------

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "swing_torques.cu"
# swing_torques(model, kp, kd, the legs' inputs, tau, B, gravity, damping,
# feedforward, stream); counted under swing.*, B the scenarios
KERNEL = CudaKernel(
    SOURCE, "swing_torques", "swing",
    inputs=(Arg("model", (MODEL_FLOATS,), batched=False),
            Arg("kp", (3,), batched=False), Arg("kd", (3,), batched=False),
            Arg("quaternion", (4,)), Arg("q", (4, 3)), Arg("qd", (4, 3)),
            Arg("p_des", (4, 3)), Arg("v_des", (4, 3)), Arg("a_des", (4, 3))),
    outputs=(Arg("tau", (4, 3)),), scalars=(ctypes.c_float,) * 3)


def swing_flops() -> int:
    """Floating-point operations of one leg's torques, counted from the
    kernel's arithmetic (a multiply and an add are 1 each, as are a
    division and a sine or cosine; comparisons and selects are not
    counted): a cross product is 9, a 3×3 matrix-vector product 15, a dot
    product 5; gravity in the hip frame (two cross products, the
    quaternion's update, the hip's rotation); the chain (3 sines and
    cosines, R2's products, R3's columns, the knee and the foot, the three
    centres of mass); the links' angular velocities and bias
    accelerations; the Jacobian and J q̇; the PD force (two rotations into
    the base frame, the gains, one back); J̇ q̇ (a point of link 3) and the
    right-hand side; J Jᵀ + damping, the cofactors, the determinant, the
    reciprocal, the solve and q̈; the inverse dynamics (q̈ into the
    accelerations, each link's centre-of-mass acceleration, force, moment
    in its own frame and about the hip, the knee's moment, the joint
    torques); the output."""
    cross, mv3, dot = 9, 15, 5
    gravity = 2 * cross + 3 * 4 + mv3
    chain = 6 + 4 + 2 * 3 * 3 + 3 * 3 + 3 * 2 + 3 * mv3 + 3
    motion = 3 + 6 + 6 + 3 + cross + 3 + cross + 3
    turning = cross + 2 * cross + 3  # a point of link 1 or 2
    shank = 2 * turning + 6  # a point of link 3
    jacobian = 3 + 3 * cross + 3 * 5
    pd = 2 * mv3 + 3 * 6 + mv3
    bias = shank + mv3 + 3
    solve = 9 * 5 + 3 + 9 * 3 + dot + 1 + 3 * 6 + 3 * (dot + 1)
    link = 6 + 4 * mv3 + cross + 3 + mv3 + cross + 3
    rnea = (3 * (1 + 3 + 4) + 2 * turning + shank + 3 * link
            + 3 + cross + 3 + 3 + 1 + 2 * dot)
    out = 3 * (dot + 1)
    return (gravity + chain + motion + jacobian + pd + bias + solve + rnea
            + out)


def swing_bytes(batch: int) -> int:
    """Bytes one launch must move: the model and the gains once, each
    scenario's quaternion and its legs' q, q̇, p_des, v_des, a_des read once
    and their torques written once (float32)."""
    return 4 * (MODEL_FLOATS + 6) + batch * 4 * (4 + 5 * 12 + 12)


def _lead(state: RobotState, *refs: torch.Tensor) -> torch.Size:
    """The leading dims of the law's inputs, broadcast."""
    return torch.broadcast_shapes(state.base.quaternion.shape[:-1],
                                  *(t.shape[:-2] for t in (state.q, state.qd,
                                                           *refs)))


def kernel_inputs(model: RobotModel, gains: SwingGains, state: RobotState,
                  p_des_base: torch.Tensor, v_des_base: torch.Tensor,
                  a_des_base: torch.Tensor) -> dict:
    """The kernel's inputs by name, in its argument order: the packed
    model, the gains, then the quaternion (B, 4) and the legs' (B, 4, 3)
    arrays, their leading dims broadcast and flattened into B and made
    contiguous (no copy where they already are)."""
    legs = (state.q, state.qd, p_des_base, v_des_base, a_des_base)
    lead = _lead(state, p_des_base, v_des_base, a_des_base)
    ins = {"model": pack_model(model), "kp": gains.kp, "kd": gains.kd,
           "quaternion": state.base.quaternion.expand(lead + (4,))
           .reshape(-1, 4)}
    for name, t in zip(("q", "qd", "p_des", "v_des", "a_des"), legs):
        ins[name] = t.expand(lead + (4, 3)).reshape(-1, 4, 3)
    return {k: t.contiguous() for k, t in ins.items()}


def swing_torques(
    model: RobotModel,
    gains: SwingGains,
    state: RobotState,
    p_des_base: torch.Tensor,  # (...,4,3) desired foot positions, base frame
    v_des_base: torch.Tensor,  # (...,4,3)
    a_des_base: torch.Tensor,  # (...,4,3)
) -> torch.Tensor:
    """Computed-torque swing control for every leg: (...,4,3). Callers
    mask by the support state (stance legs use the QP torques).

    CUDA tensors go to the kernel (:data:`KERNEL`, one launch on the
    current stream over :func:`kernel_inputs`; it raises on anything but
    float32), CPU tensors to :func:`swing_torques_plain`, which callers
    also name for the plain law on the card."""
    if not state.q.is_cuda:
        return swing_torques_plain(model, gains, state, p_des_base,
                                   v_des_base, a_des_base)
    ins = kernel_inputs(model, gains, state, p_des_base, v_des_base,
                        a_des_base)
    (tau,) = KERNEL(*ins.values(), GRAVITY, DAMPING, FEEDFORWARD)
    return tau.reshape(_lead(state, p_des_base, v_des_base, a_des_base)
                       + (4, 3))


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
