"""Quaternion / rotation algebra (≙ ``quadruped_locomotion_tpu/utils/
rotations.py``): ``(w, x, y, z)`` Hamilton quaternions, ``quat`` is the
base→world orientation, Euler angles are intrinsic Z-Y-X. Every function
works on the trailing axes and broadcasts over leading ones."""

from __future__ import annotations

import math

import torch

from ..types import const


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 0, 0, 0) on ``device`` (default CUDA)."""
    from ..types import resolve_device

    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=resolve_device(device))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (first b, then a)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * const((1.0, -1.0, -1.0, -1.0), q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (base→world if q = R_WB)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_inv_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world→base if q = R_WB)."""
    return quat_rotate(quat_conj(q), v)


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a unit quaternion: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, branch-free (the four candidates computed and
    selected per element): (..., 3, 3) -> (..., 4)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(w, x, y, z):
        return torch.stack([w, x, y, z], dim=-1)

    def root(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    s0 = root(1.0 + tr)
    q0 = mk(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = mk((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = root(1.0 - m00 + m11 - m22)
    q2 = mk((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = root(1.0 - m00 - m11 + m22)
    q3 = mk((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit ``axis`` (..., 3) and ``angle`` (...) -> (..., 4)."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def quat_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic ZYX (yaw·pitch·roll)."""
    cr, sr = torch.cos(0.5 * roll), torch.sin(0.5 * roll)
    cp, sp = torch.cos(0.5 * pitch), torch.sin(0.5 * pitch)
    cy, sy = torch.cos(0.5 * yaw), torch.sin(0.5 * yaw)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def rpy_from_quat(q: torch.Tensor):
    """(roll, pitch, yaw) of the intrinsic-ZYX decomposition."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation-vector logarithm (angle·axis), small-angle safe, |angle| ≤ π."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., 0]
    v = q[..., 1:]
    n = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    safe_n = torch.where(small, torch.ones_like(n), n)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), angle / safe_n)
    return scale[..., None] * v


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation-vector exponential R³ → SU(2)."""
    angle = torch.linalg.norm(phi, dim=-1)
    small = angle < 1e-8
    safe = torch.where(small, torch.ones_like(angle), angle)
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(0.5 * safe) / safe)
    return torch.cat([torch.cos(0.5 * angle)[..., None], k[..., None] * phi],
                     dim=-1)


def quat_boxminus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """kindr-style boxMinus: log(q1 ⊗ q2⁻¹)."""
    return quat_log(quat_mul(q1, quat_conj(q2)))


def quat_boxplus(q: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """kindr-style boxPlus: exp(phi) ⊗ q (global perturbation)."""
    return quat_mul(quat_exp(phi), q)


def skew(v: torch.Tensor) -> torch.Tensor:
    """skew(v) @ u == v × u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap to (-π, π]."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def rotz(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    m = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1)
    return m.reshape(angle.shape + (3, 3))
