"""Base-pose optimization cascade: Geometric → QP → Checker → SQP (≙
``quadruped_locomotion_tpu/planning/pose_optimization.py``), which
BaseAuto runs to place the torso over a new stance.

Every stage is a fixed-shape, mask-driven function of

* ``feet_world``     (...,4,3) foothold positions,
* ``support``        (...,4)   stance mask,
* ``nominal_stance`` (...,4,3) nominal foot positions in the base frame,

over leading batch dims. Every QP goes through the generic IPM
(``ops.qp.solve_qp``), as in the JAX package.

* :func:`geometric_pose`: support centroid + average height, roll and
  pitch from the Davenport q-method (scaled by 0.7), heading from the
  fore/hind foot midpoints;
* :func:`pose_qp`: 3-variable position QP with the CoM projection
  inside the support polygon;
* :func:`check_pose`: CoM in the polygon and limb lengths, 0.02 m
  tolerance;
* :func:`pose_sqp`: SE(3) Gauss-Newton SQP, a fixed iteration count with
  a converged freeze.

Two host-side tests replace the reference's traced control flow and give
the same values: :func:`optimize_pose` runs the SQP only when some
instance fails the check (``lax.cond`` at B = 1, the per-instance select
under ``vmap``), and :func:`pose_sqp` stops solving once every instance
has converged (its frozen iterations only re-normalize the quaternion).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import qp as qplib
from ..terrain.support_polygon import support_halfspaces
from ..types import RobotModel
from ..utils.rotations import (
    quat_exp, quat_from_rpy, quat_mul, quat_normalize, quat_rotate,
    rpy_from_quat, skew,
)

COM_WEIGHT = 10.0  # the objective's CoM weight
SQP_MAX_ITERATIONS = 30
SQP_TOLERANCE = 0.05
CHECK_TOLERANCE = 0.02
ROLL_PITCH_FACTOR = 0.7  # the geometric stage's adaptation factor


class Pose(NamedTuple):
    position: torch.Tensor  # (...,3)
    quaternion: torch.Tensor  # (...,4) wxyz


def limb_length_limits(model: RobotModel):
    """(min, max) hip-to-foot distance: 25 % and 95 % of the reach, clear
    of the straight-knee singularity."""
    reach = torch.sqrt(model.d**2 + (model.l1 + model.l2) ** 2)
    return 0.25 * reach, 0.95 * reach


def default_nominal_stance(model: RobotModel, height=0.4) -> torch.Tensor:
    """Feet below the kinematic hips at the nominal height (base frame);
    ``height`` a number or a (...) tensor."""
    h = torch.as_tensor(height, dtype=model.hip_pos.dtype,
                        device=model.hip_pos.device)
    ez = model.hip_pos.new_tensor([0.0, 0.0, 1.0])
    return model.hip_pos - ez * h[..., None, None]


def _masked_mean(x, mask):
    m = mask.to(x.dtype)[..., None]
    n = torch.clamp(m.sum(-2), min=1.0)
    return (x * m).sum(-2) / n


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _pose_jacobian(r):
    """[I, −[r]×] (...,3,6): d(p + R b)/dδ of the body-frame box-plus."""
    eye = _eye(3, r).expand(r.shape[:-1] + (3, 3))
    return torch.cat([eye, -skew(r)], dim=-1)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def geometric_pose(feet_world, support, nominal_stance) -> Pose:
    """Closed-form initial pose."""
    dtype = feet_world.dtype
    mask = support.to(dtype)[..., None]
    center = _masked_mean(feet_world, support)
    z = _masked_mean(feet_world - nominal_stance, support)[..., 2]
    position = torch.stack([center[..., 0], center[..., 1], z], dim=-1)

    # Davenport q-method on centred correspondences R·b̄_i ≈ ā_i.
    a = (feet_world - center[..., None, :]) * mask
    b = (nominal_stance - _masked_mean(nominal_stance, support)[..., None, :]
         ) * mask
    B = a.mT @ b  # (...,3,3) attitude profile
    sigma = B.diagonal(dim1=-2, dim2=-1).sum(-1)
    S = B + B.mT
    zvec = torch.stack([B[..., 1, 2] - B[..., 2, 1], B[..., 2, 0] - B[..., 0, 2],
                        B[..., 0, 1] - B[..., 1, 0]], dim=-1)
    top = torch.cat([sigma[..., None], zvec], dim=-1)[..., None, :]
    rest = torch.cat([zvec[..., None],
                      S - sigma[..., None, None] * _eye(3, S)], dim=-1)
    K = torch.cat([top, rest], dim=-2)
    _, vecs = torch.linalg.eigh(K)  # ascending: the last is the maximum
    q_opt = quat_normalize(vecs[..., -1])
    q_opt = q_opt * torch.sign(q_opt[..., :1] + 1e-30)

    # heading from the fore/hind midpoints, roll/pitch scaled by 0.7
    fore = 0.5 * (feet_world[..., 0, :] + feet_world[..., 1, :])
    hind = 0.5 * (feet_world[..., 2, :] + feet_world[..., 3, :])
    head = fore - hind
    yaw = torch.atan2(head[..., 1], head[..., 0])
    roll, pitch, _ = rpy_from_quat(q_opt)
    quaternion = quat_from_rpy(ROLL_PITCH_FACTOR * roll,
                               ROLL_PITCH_FACTOR * pitch, yaw)
    return Pose(position=position, quaternion=quaternion)


def pose_qp(model, pose: Pose, feet_world, support, nominal_stance,
            com_in_base=None, margin=0.0, iters: int = 25,
            polygon_feet=None, polygon_support=None) -> Pose:
    """Position-only QP refinement (orientation held fixed):
    min_p Σ_i ‖p + R·b_i − f_i‖² s.t. (p + R·com)_xy inside the support
    polygon."""
    dtype = feet_world.dtype
    if com_in_base is None:
        com_in_base = model.com_in_base.to(dtype)
    n_sup = torch.clamp(support.to(dtype).sum(-1), min=1.0)
    rb = quat_rotate(pose.quaternion[..., None, :], nominal_stance)
    target = _masked_mean(feet_world - rb, support)  # unconstrained optimum

    # QP in x = p: G = 2 n I, g = −2 n · target
    G = (2.0 * n_sup)[..., None, None] * _eye(3, feet_world)
    g = (-2.0 * n_sup)[..., None] * target
    if polygon_feet is None:
        polygon_feet = feet_world
    if polygon_support is None:
        polygon_support = support
    normals, offsets = support_halfspaces(polygon_feet[..., :2],
                                          polygon_support, margin=margin)
    r_com = quat_rotate(pose.quaternion, com_in_base)
    # normals·(p_xy + Rcom_xy) ≥ offsets → D p ≥ d
    D = torch.cat([normals, torch.zeros_like(normals[..., :1])], dim=-1)
    d = offsets - _mv(normals, r_com[..., :2])
    sol = qplib.solve_qp(G, g, D, d, iters=iters)
    return Pose(position=sol.x, quaternion=pose.quaternion)


def _limb_defaults(model, min_limb_length, max_limb_length):
    if min_limb_length is None or max_limb_length is None:
        lo, hi = limb_length_limits(model)
        min_limb_length = lo if min_limb_length is None else min_limb_length
        max_limb_length = hi if max_limb_length is None else max_limb_length
    return min_limb_length, max_limb_length


def check_pose(model, pose: Pose, feet_world, support, min_limb_length=None,
               max_limb_length=None, tolerance: float = CHECK_TOLERANCE,
               com_in_base=None, polygon_feet=None, polygon_support=None,
               limb_feet=None, limb_support=None) -> torch.Tensor:
    """(...) True where the pose keeps the CoM inside the support region
    and every stance limb within its length limits. The polygon may come
    from another stance than the limbs; ``limb_feet`` stacks (k·4, 3)
    foothold sets in leg order. Defaults: ``feet_world``/``support``."""
    dtype = feet_world.dtype
    lo, hi = _limb_defaults(model, min_limb_length, max_limb_length)
    if com_in_base is None:
        com_in_base = model.com_in_base.to(dtype)
    if polygon_feet is None:
        polygon_feet = feet_world
    if polygon_support is None:
        polygon_support = support
    if limb_feet is None:
        limb_feet = feet_world
    if limb_support is None:
        limb_support = support
    normals, offsets = support_halfspaces(polygon_feet[..., :2],
                                          polygon_support, margin=0.0)
    com_w = pose.position + quat_rotate(pose.quaternion, com_in_base)
    inside = (_mv(normals, com_w[..., :2]) >= offsets - tolerance).all(-1)

    # limb lengths from each foot's own hip
    hips = model.hip_pos.to(dtype).repeat(limb_feet.shape[-2] // 4, 1)
    hips_w = pose.position[..., None, :] + quat_rotate(
        pose.quaternion[..., None, :], hips)
    lengths = torch.linalg.norm(limb_feet - hips_w, dim=-1)
    ok_len = (lengths >= lo - tolerance) & (lengths <= hi + tolerance)
    return inside & (ok_len | ~limb_support).all(-1)


def pose_sqp(model, pose0: Pose, feet_world, support, nominal_stance,
             com_in_base=None, com_weight: float = COM_WEIGHT,
             min_limb_length=None, max_limb_length=None,
             iterations: int = SQP_MAX_ITERATIONS,
             tolerance: float = SQP_TOLERANCE, qp_iters: int = 25,
             margin=0.0, polygon_feet=None, polygon_support=None,
             limb_feet=None, limb_support=None) -> Pose:
    """SE(3) Gauss-Newton SQP: nominal-stance residuals plus the CoM over
    the polygon's centroid (weight ``com_weight``), subject to the
    support polygon and limb-length rows; position-plus / body-frame
    quaternion box-plus retraction; ``iterations`` steps, an instance
    freezing once its step is shorter than ``tolerance``.

    ``limb_feet``/``limb_support`` (...,4k,3)/(...,4k) default to the cost
    stance plus the polygon legs."""
    dtype = feet_world.dtype
    lo, hi = _limb_defaults(model, min_limb_length, max_limb_length)
    if com_in_base is None:
        com_in_base = model.com_in_base.to(dtype)
    mask = support.to(dtype)
    if polygon_feet is None:
        polygon_feet = feet_world
    if polygon_support is None:
        polygon_support = support
    if limb_feet is None:
        limb_feet = torch.cat([feet_world, polygon_feet], dim=-2)
        limb_support = torch.cat([support, polygon_support], dim=-1)
    limb_mask = limb_support.to(dtype)
    normals, offsets = support_halfspaces(polygon_feet[..., :2],
                                          polygon_support, margin=margin)
    centroid = _masked_mean(polygon_feet, polygon_support)[..., :2]
    sqrt_w = torch.sqrt(torch.tensor(com_weight, dtype=dtype))
    hips_b = model.hip_pos.to(dtype).repeat(limb_feet.shape[-2] // 4, 1)
    eye6 = _eye(6, feet_world)

    def gn_step(p, q):
        R_b = quat_rotate(q[..., None, :], nominal_stance)
        # stance residuals r_i = p + R b_i − f_i, Jacobian [I, −[R b_i]×]
        r = (p[..., None, :] + R_b - feet_world) * mask[..., None]
        J = _pose_jacobian(R_b) * mask[..., None, None]  # (...,4,3,6)
        # CoM-centroid residual (xy), weight w
        r_com3 = quat_rotate(q, com_in_base)
        com_w = p + r_com3
        rc = sqrt_w * (com_w[..., :2] - centroid)
        Jcom_xy = _pose_jacobian(r_com3)[..., :2, :]
        Jc = sqrt_w * Jcom_xy
        H = (torch.einsum("...lij,...lik->...jk", J, J) + Jc.mT @ Jc
             + 1e-6 * eye6)
        g = torch.einsum("...lij,...li->...j", J, r) + _mv(Jc.mT, rc)

        # constraints on δ: polygon rows + limb-length boxes
        D_poly = normals @ Jcom_xy  # (...,MAX_EDGES,6)
        d_poly = offsets - _mv(normals, com_w[..., :2])
        hips_r = quat_rotate(q[..., None, :], hips_b)
        v = p[..., None, :] + hips_r - limb_feet  # hip-to-foot
        vlen = torch.clamp(torch.linalg.norm(v, dim=-1), min=1e-6)
        vhat = v / vlen[..., None]
        row = torch.einsum("...li,...lij->...lj", vhat, _pose_jacobian(hips_r))
        # min ≤ ‖v‖ + row·δ ≤ max, for the legs of either support set
        D = torch.cat([D_poly, row * limb_mask[..., None],
                       -row * limb_mask[..., None]], dim=-2)
        d = torch.cat([d_poly, (lo - vlen) * limb_mask,
                       (vlen - hi) * limb_mask], dim=-1)
        return qplib.solve_qp(2.0 * H, 2.0 * g, D, d, iters=qp_iters).x

    p, q = pose0.position, pose0.quaternion
    done = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    for it in range(iterations):
        if bool(done.all()):
            # Every instance is frozen: the reference's remaining steps
            # add 0·δ to p (a no-op) and multiply q by exp(0) = 1 before
            # normalizing, so only the normalization is left to repeat.
            for _ in range(iterations - it):
                q = quat_normalize(q)
            break
        delta = gn_step(p, q)
        step_norm = torch.linalg.norm(delta, dim=-1)
        take = torch.where(done, 0.0, 1.0).to(dtype)[..., None]
        done = done | (step_norm < tolerance)
        p = p + take * delta[..., :3]
        q = quat_normalize(quat_mul(q, quat_exp(take * delta[..., 3:])))
    return Pose(position=p, quaternion=q)


def optimize_pose(model, feet_world, support, nominal_stance=None,
                  height=0.4, margin=0.0, polygon_feet=None,
                  polygon_support=None, limb_feet=None, limb_support=None,
                  return_status: bool = False, **sqp_kwargs):
    """The BaseAuto cascade: geometric init → position QP → constraints
    check → SE(3) SQP, the SQP only for a pose that fails the check.

    ``polygon_feet``/``polygon_support`` constrain the CoM to another
    region than the cost stance (the legs that keep support during the
    motion). With ``return_status=True`` also returns the final check
    verdict (...)."""
    if nominal_stance is None:
        nominal_stance = default_nominal_stance(model, height)
    pose = geometric_pose(feet_world, support, nominal_stance)
    pose_q = pose_qp(model, pose, feet_world, support, nominal_stance,
                     margin=margin, polygon_feet=polygon_feet,
                     polygon_support=polygon_support)
    check = lambda p: check_pose(  # noqa: E731
        model, p, feet_world, support, polygon_feet=polygon_feet,
        polygon_support=polygon_support, limb_feet=limb_feet,
        limb_support=limb_support)
    qp_ok = check(pose_q)
    # One host read stands for lax.cond (B = 1) and its vmap select.
    if bool(qp_ok.all()):
        pose = pose_q
    else:
        sqp = pose_sqp(model, pose_q, feet_world, support, nominal_stance,
                       margin=margin, polygon_feet=polygon_feet,
                       polygon_support=polygon_support, limb_feet=limb_feet,
                       limb_support=limb_support, **sqp_kwargs)
        keep = qp_ok[..., None]
        pose = Pose(position=torch.where(keep, pose_q.position, sqp.position),
                    quaternion=torch.where(keep, pose_q.quaternion,
                                           sqp.quaternion))
    if not return_status:
        return pose
    return pose, qp_ok | check(pose)
