"""Base state estimation: IMU + leg-odometry error-state EKF, batched over
scenarios (≙ ``quadruped_locomotion_tpu/control/state_estimator.py``).

The filter state stacks base position, velocity and orientation error
and all four foot positions (a 21-dim error state); swing legs get
inflated process and measurement noise instead of a smaller measurement,
so shapes stay fixed. One predict (strapdown IMU) and one joint 12-dim
update (forward kinematics of the measured joints gives each foot in the
base frame, ``s_i = Rᵀ(pf_i − p)``) per control tick. The orientation is
a unit quaternion with the error in the tangent space (boxplus).

Every array leads with the scenario axis B. Products are full float32
(TF32 off, ``types.full_f32_matmuls``): bf16- or TF32-rounded products
destroy the covariance's positive definiteness within a few hundred
ticks. The gain's Cholesky uses ``cholesky_ex``: a failed factor becomes
NaN and nothing syncs the host or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..model.kinematics import forward_kinematics, mv
from ..types import GRAVITY, RobotModel, TensorStruct, resolve_device
from ..utils.rotations import (
    matrix_from_quat, quat_boxplus, quat_conj, quat_mul, quat_normalize, skew,
)

# error-state layout: [δp(0:3), δv(3:6), δθ(6:9), δpf(9:21)]
NX = 21
NZ = 12  # stacked foot-in-base measurements


@dataclass
class EstimatorParams(TensorStruct):
    """Noise densities (continuous time, SI units)."""

    sigma_accel: torch.Tensor  # m/s² /√Hz accelerometer white noise
    sigma_gyro: torch.Tensor  # rad/s /√Hz gyro white noise
    sigma_foot_stance: torch.Tensor  # m/√s stance-foot slip random walk
    sigma_foot_swing: torch.Tensor  # m/√s swing feet: effectively free
    sigma_joint: torch.Tensor  # m forward-kinematics measurement noise
    sigma_swing_meas: torch.Tensor  # m inflated noise of swing legs

    @classmethod
    def defaults(cls, device=None, dtype=torch.float32) -> "EstimatorParams":
        dev = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
        return cls(sigma_accel=f(0.05), sigma_gyro=f(0.005),
                   sigma_foot_stance=f(0.001), sigma_foot_swing=f(10.0),
                   sigma_joint=f(0.002), sigma_swing_meas=f(1e3))


@dataclass
class EstimatorState(TensorStruct):
    position: torch.Tensor  # (B,3) world
    velocity: torch.Tensor  # (B,3) world
    quaternion: torch.Tensor  # (B,4) wxyz base→world
    foot_positions: torch.Tensor  # (B,4,3) world
    covariance: torch.Tensor  # (B,21,21)


def init_state(position: torch.Tensor, quaternion: torch.Tensor,
               foot_positions: torch.Tensor, pos_std: float = 0.01,
               foot_std: float | None = None) -> EstimatorState:
    """Filter state at the given (B,...) pose. ``foot_std`` defaults to
    ``pos_std``; a small value (known touchdown points) attributes
    corrections to the base, since the common translation of base and
    feet is unobservable."""
    foot_std = pos_std if foot_std is None else foot_std
    dtype, dev = position.dtype, position.device
    p0 = torch.cat([torch.full((3,), pos_std ** 2, dtype=dtype, device=dev),
                    torch.full((6,), 0.01 ** 2, dtype=dtype, device=dev),
                    torch.full((12,), foot_std ** 2, dtype=dtype, device=dev)])
    B = position.shape[0]
    return EstimatorState(
        position=position, velocity=torch.zeros_like(position),
        quaternion=quaternion, foot_positions=foot_positions,
        covariance=torch.diag(p0).expand(B, NX, NX).clone())


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def predict(params: EstimatorParams, est: EstimatorState,
            gyro: torch.Tensor,  # (B,3) body-frame angular rate
            accel: torch.Tensor,  # (B,3) body-frame specific force
            contact: torch.Tensor,  # (B,4) bool, gates the foot process noise
            dt: float) -> EstimatorState:
    """Strapdown IMU mechanization + covariance propagation."""
    p = est.position
    g = p.new_tensor([0.0, 0.0, -GRAVITY])
    R = matrix_from_quat(est.quaternion)
    Ra = mv(R, accel)
    a_w = Ra + g
    p2 = p + est.velocity * dt + 0.5 * a_w * dt * dt
    v2 = est.velocity + a_w * dt
    q2 = quat_normalize(quat_boxplus(est.quaternion, gyro * dt))

    # first-order error-state transition
    B = p.shape[0]
    eye3 = _eye(3, p)
    F = _eye(NX, p).expand(B, NX, NX).clone()
    F[:, 0:3, 3:6] = eye3 * dt
    F[:, 3:6, 6:9] = -skew(Ra) * dt
    F[:, 6:9, 6:9] = eye3 - skew(gyro) * dt

    sigma_foot = torch.where(contact, params.sigma_foot_stance,
                             params.sigma_foot_swing)
    sa, sg = params.sigma_accel, params.sigma_gyro
    q_diag = torch.cat([
        ((0.5 * sa * dt * dt) ** 2).expand(B, 3),
        ((sa * dt) ** 2).expand(B, 3),
        ((sg * dt) ** 2).expand(B, 3),
        (sigma_foot ** 2 * dt).repeat_interleave(3, dim=-1),
    ], dim=-1)
    P2 = F @ est.covariance @ F.mT + torch.diag_embed(q_diag)
    P2 = 0.5 * (P2 + P2.mT)
    return EstimatorState(position=p2, velocity=v2, quaternion=q2,
                          foot_positions=est.foot_positions, covariance=P2)


def update(model: RobotModel, params: EstimatorParams, est: EstimatorState,
           q_joints: torch.Tensor,  # (B,4,3) measured joint positions
           contact: torch.Tensor,  # (B,4) bool
           ) -> EstimatorState:
    """Joint kinematic update: fuse the stance legs' FK foot positions
    (Joseph-form covariance update)."""
    p, pf = est.position, est.foot_positions
    B = p.shape[0]
    R = matrix_from_quat(est.quaternion)
    Rt = R.mT
    s_meas = forward_kinematics(model, q_joints)  # (B,4,3) foot in base
    s_pred = (pf - p[:, None, :]) @ R  # rows of Rᵀ(pf − p)
    y = (s_meas - s_pred).reshape(B, NZ)

    # measurement Jacobian, rows stacked per leg
    H = p.new_zeros(B, NZ, NX)
    for i in range(4):
        r = slice(3 * i, 3 * i + 3)
        H[:, r, 0:3] = -Rt
        H[:, r, 6:9] = skew(mv(Rt, pf[:, i] - p))
        H[:, r, 9 + 3 * i:12 + 3 * i] = Rt

    meas_sigma = torch.where(contact, params.sigma_joint,
                             params.sigma_swing_meas)
    Rm = torch.diag_embed((meas_sigma ** 2).repeat_interleave(3, dim=-1))
    P = est.covariance
    S = H @ P @ H.mT + Rm
    # K = P Hᵀ S⁻¹ through a Cholesky factor of S (SPD by construction)
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where((info == 0)[:, None, None], L,
                    torch.full_like(L, float("nan")))
    K = torch.cholesky_solve(H @ P, L).mT  # (B,NX,NZ)
    dx = mv(K, y)

    IKH = _eye(NX, p) - K @ H
    P2 = IKH @ P @ IKH.mT + K @ Rm @ K.mT
    P2 = 0.5 * (P2 + P2.mT)
    return EstimatorState(
        position=p + dx[:, 0:3],
        velocity=est.velocity + dx[:, 3:6],
        quaternion=quat_normalize(quat_boxplus(est.quaternion, dx[:, 6:9])),
        foot_positions=pf + dx[:, 9:21].reshape(B, 4, 3),
        covariance=P2,
    )


def step(model: RobotModel, params: EstimatorParams, est: EstimatorState,
         gyro: torch.Tensor, accel: torch.Tensor, q_joints: torch.Tensor,
         contact: torch.Tensor, dt: float) -> EstimatorState:
    """One filter tick: predict + update."""
    est = predict(params, est, gyro, accel, contact, dt)
    return update(model, params, est, q_joints, contact)


def synthesize_imu(base_quat: torch.Tensor,  # (T,...,4)
                   base_pos: torch.Tensor,  # (T,...,3)
                   dt: float):
    """Ideal body-frame IMU signals from a recorded base trajectory (for
    tests and golden traces; a robot supplies these). Returns (gyro, accel),
    each (T-1,...,3), valid for steps 1..T-1."""
    g = base_pos.new_tensor([0.0, 0.0, -GRAVITY])
    v = torch.diff(base_pos, dim=0) / dt  # mean world velocity per interval
    a_w = torch.diff(torch.cat([v[:1], v], dim=0), dim=0) / dt
    q0, q1 = base_quat[:-1], base_quat[1:]
    dq = quat_mul(quat_conj(q0), q1)
    dq = dq * torch.where(dq[..., :1] < 0, -1.0, 1.0)
    vec_norm = torch.linalg.norm(dq[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(vec_norm, dq[..., 0])
    axis = dq[..., 1:] / torch.clamp(vec_norm, min=1e-9)[..., None]
    gyro = axis * (angle / dt)[..., None]
    accel = mv(matrix_from_quat(q0).mT, a_w - g)
    return gyro, accel
