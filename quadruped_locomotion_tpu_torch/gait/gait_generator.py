"""Trot/pace gait engine: Raibert footholds, swing splines, smoothed base
reference (≙ ``quadruped_locomotion_tpu/gait/gait_generator.py``). Every
array carries leading scenario dims; legs are the axis after them.
``GaitParams`` may be shared or per scenario (see ``phase.py``). With a
per-scenario ``Heightfield``, footholds snap to the nearest traversable
cell and the surface normals come from the map."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..terrain import heightfield as hf_mod
from ..types import GRAVITY, BaseTarget, RobotModel, RobotState, TensorStruct
from ..utils.rotations import quat_from_rpy, quat_inv_rotate, quat_rotate, rpy_from_quat
from . import phase as phase_mod
from .footstep import PROFILE_TRIANGLE, swing_trajectory
from .phase import GaitParams, PhaseState
from .spline import MAX_KNOTS, HermiteSpline


@dataclass
class GaitState(TensorStruct):
    phase: PhaseState
    swing_splines: HermiteSpline  # leading (...,4) dims
    swing_targets: torch.Tensor  # (...,4,3) world
    swing_starts: torch.Tensor  # (...,4,3) world foot position at lift-off
    base_ref_pos: torch.Tensor  # (...,3) smoothed base reference
    base_ref_vel: torch.Tensor  # (...,3)
    yaw_ref: torch.Tensor  # (...) integrated, clamped yaw command


def _empty_splines(feet_world: torch.Tensor) -> HermiteSpline:
    lead = feet_world.shape[:-1]  # (...,4)
    vals = feet_world[..., None, :].expand(lead + (MAX_KNOTS, 3)).clone()
    return HermiteSpline(
        times=feet_world.new_zeros(lead + (MAX_KNOTS,)),
        values=vals,
        tangents=torch.zeros_like(vals),
        num_knots=torch.full(lead, 2, dtype=torch.int32,
                             device=feet_world.device),
        duration=feet_world.new_zeros(lead),
    )


def init_gait_state(gait_type: int, params: GaitParams,
                    feet_world: torch.Tensor) -> GaitState:
    """feet_world (...,4,3) -> the gait state of a standing start."""
    batch = feet_world.shape[:-2]
    if gait_type == phase_mod.PACE:
        ph = PhaseState.init_pace(params, batch)
    else:
        ph = PhaseState.init_trot(params, batch)
    footprint = feet_world.mean(-2)
    ref_z = params.height + feet_world[..., 2].mean(-1) - 0.02
    return GaitState(
        phase=ph,
        swing_splines=_empty_splines(feet_world),
        swing_targets=feet_world,
        swing_starts=feet_world,
        base_ref_pos=torch.cat([footprint[..., :2], ref_z[..., None]], -1),
        base_ref_vel=torch.zeros_like(footprint),
        yaw_ref=feet_world.new_zeros(batch),
    )


def _set_z(v: torch.Tensor, z) -> torch.Tensor:
    return torch.cat([v[..., :2], torch.as_tensor(z).expand(
        v.shape[:-1] + (1,)).to(v)], dim=-1)


def raibert_footholds(
    model: RobotModel,
    state: RobotState,
    params: GaitParams,
    v_desired_world: torch.Tensor,  # (...,3)
    footprint_center_z: torch.Tensor,  # (...) mean support-foot height
    ground_height=0.0,  # scalar or (...,4) terrain height under the hips
    capture_gain=1.0,  # scalar, (2,) or (...,2)
    yaw_rate_desired=0.0,  # (...) or scalar
) -> torch.Tensor:
    """Target footholds in world frame: (...,4,3). Kinematic hip projected
    to the ground (z = ``ground_height``) plus the Raibert displacement
    0.5·t_st·v_des + √(z_hip/g)·(v − v_des), rotated by the base yaw."""
    base = state.base
    dtype, dev = v_desired_world.dtype, v_desired_world.device
    xy = torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev)

    v_cur_base = quat_inv_rotate(base.quaternion, base.linear_velocity) * xy
    _, _, yaw = rpy_from_quat(base.quaternion)
    q_yaw = quat_from_rpy(torch.zeros_like(yaw), torch.zeros_like(yaw), yaw)
    v_des_fp = quat_inv_rotate(q_yaw, v_desired_world) * xy

    z_hip = torch.clamp(base.position[..., 2] - footprint_center_z, min=1e-3)
    cap = torch.as_tensor(capture_gain, dtype=dtype, device=dev)
    if cap.dim() == 0:
        cap = cap.expand(2)
    cap3 = torch.cat([cap, torch.zeros_like(cap[..., :1])], dim=-1)
    t_st = params.t_stance[..., None]
    displace_fp = 0.5 * t_st * v_des_fp + cap3 * torch.sqrt(
        z_hip / GRAVITY)[..., None] * (v_cur_base - v_des_fp)
    displace_fp = _set_z(displace_fp, 0.0)

    # kinematic hips projected to the ground under them
    gz = torch.as_tensor(ground_height, dtype=dtype, device=dev)
    hips_world = base.position[..., None, :] + quat_rotate(
        base.quaternion[..., None, :], model.hip_pos.to(dtype))
    hips_world = hips_world * xy + gz[..., None] * (1 - xy)

    displace_world = _set_z(quat_rotate(q_yaw, displace_fp), 0.0)
    # turning: place each foothold half a stance ahead along the hip's arc
    wz = torch.as_tensor(yaw_rate_desired, dtype=dtype, device=dev)
    hip_fp = model.hip_pos.to(dtype)
    arc = torch.stack([-hip_fp[:, 1], hip_fp[:, 0], torch.zeros_like(hip_fp[:, 0])],
                      dim=-1)
    tangential = wz[..., None, None] * arc
    displace_yaw = quat_rotate(q_yaw[..., None, :],
                               0.5 * t_st[..., None] * tangential)
    return hips_world + displace_world[..., None, :] + displace_yaw * xy


def _hermite_refit_step(p0, v0, p1, v1, duration, dt):
    """Advance a (pos, vel) reference one tick along the cubic Hermite
    from (p0, v0) to (p1, v1) over ``duration`` (...)."""
    s = torch.clamp(dt / duration, 0.0, 1.0)[..., None]
    dur = duration[..., None]
    h00 = 2 * s**3 - 3 * s**2 + 1
    h10 = s**3 - 2 * s**2 + s
    h01 = -2 * s**3 + 3 * s**2
    h11 = s**3 - s**2
    p = h00 * p0 + h10 * dur * v0 + h01 * p1 + h11 * dur * v1
    g00 = 6 * s**2 - 6 * s
    g10 = 3 * s**2 - 4 * s + 1
    g01 = -6 * s**2 + 6 * s
    g11 = 3 * s**2 - 2 * s
    v = (g00 * p0 + g10 * dur * v0 + g01 * p1 + g11 * dur * v1) / dur
    return p, v


def com_target_raw(gait: GaitState, params: GaitParams,
                   feet_world: torch.Tensor) -> torch.Tensor:
    """Raw erf-weighted virtual-CoM point (...,3)."""
    w = phase_mod.com_weights(gait.phase, params)  # (...,4)
    f = feet_world
    vp_sum = torch.zeros_like(f[..., 0, :])
    for j in range(4):  # LF, RF, RH, LH is a cycle around the body
        cw, ccw = (j + 1) % 4, (j - 1) % 4
        wj, wcw, wccw = w[..., j, None], w[..., cw, None], w[..., ccw, None]
        vp_cw = f[..., j, :] * wj + f[..., cw, :] * (1 - wj)
        vp_ccw = f[..., j, :] * wj + f[..., ccw, :] * (1 - wj)
        denom = torch.clamp(wj + wcw + wccw, min=1e-6)
        vp_sum = vp_sum + (wj * f[..., j, :] + wcw * vp_cw + wccw * vp_ccw) / denom
    com_des = 0.25 * vp_sum
    support = gait.phase.support.to(f.dtype)
    n_sup = torch.clamp(support.sum(-1), min=1.0)
    footprint_z = (f[..., 2] * support).sum(-1) / n_sup
    return _set_z(com_des, (params.height + footprint_z - 0.02)[..., None])


def base_target_smoothed(
    model: RobotModel,
    state: RobotState,
    gait: GaitState,
    params: GaitParams,
    feet_world: torch.Tensor,
    v_desired_world: torch.Tensor,
    yaw_rate_desired: torch.Tensor,
    dt: float,
):
    """One Hermite-refit tick of the base reference toward the virtual-CoM
    point. Returns (BaseTarget, ref_pos, ref_vel, yaw_ref)."""
    dtype = feet_world.dtype
    sup = gait.phase.support.to(dtype)
    # CoM target over anchor feet: actual positions for support legs,
    # capture-free nominal footholds for swing legs
    nominal = raibert_footholds(
        model, state, params, v_desired_world,
        (feet_world[..., 2] * sup).sum(-1) / torch.clamp(sup.sum(-1), min=1.0),
        capture_gain=0.0, yaw_rate_desired=yaw_rate_desired,
    )
    feet_anchor = torch.where(gait.phase.support[..., None], feet_world, nominal)
    xy = v_desired_world.new_tensor([1.0, 1.0, 0.0])
    # lead the CoM target one stance period ahead along the command
    com_des = com_target_raw(gait, params, feet_anchor) + (
        params.t_stance[..., None] * v_desired_world * xy)

    dist = torch.linalg.norm(com_des - gait.base_ref_pos, dim=-1)
    duration = torch.clamp(dist / params.base_avg_velocity, 0.2, 2.0)
    ref_pos, ref_vel = _hermite_refit_step(
        gait.base_ref_pos, gait.base_ref_vel, com_des, v_desired_world,
        duration, dt)

    # integrated yaw command, clamped to ±0.3 rad of the measured yaw
    _, _, yaw = rpy_from_quat(state.base.quaternion)
    wz = yaw_rate_desired
    yaw_err = gait.yaw_ref + wz * dt - yaw
    yaw_err = torch.remainder(yaw_err + math.pi, 2 * math.pi) - math.pi
    yaw_ref = yaw + torch.clamp(yaw_err, -0.3, 0.3)
    zero = torch.zeros_like(yaw)
    a = params.vel_cmd_blend
    v_ref = torch.stack([
        a * v_desired_world[..., 0] + (1 - a) * ref_vel[..., 0],
        a * v_desired_world[..., 1] + (1 - a) * ref_vel[..., 1],
        ref_vel[..., 2],
    ], dim=-1)
    target = BaseTarget(
        position=ref_pos,
        quaternion=quat_from_rpy(zero, zero, yaw_ref),
        linear_velocity=v_ref,
        angular_velocity=torch.stack([zero, zero, wz.expand_as(zero)], -1),
    )
    return target, ref_pos, ref_vel, yaw_ref


def advance(
    model: RobotModel,
    gait: GaitState,
    state: RobotState,
    feet_world: torch.Tensor,  # (...,4,3)
    params: GaitParams,
    v_desired_world: torch.Tensor,  # (...,3)
    yaw_rate_desired: torch.Tensor,  # (...)
    dt: float,
    terrain=None,
):
    """One gait tick. Returns (new GaitState, support (...,4), swing foot
    (pos, vel, acc) in world (each (...,4,3)), BaseTarget, surface
    normals (...,4,3)). With a ``terrain`` Heightfield (one map per
    scenario), footholds snap to the nearest traversable cell within
    reach of the hip, and every leg's normal is its target cell's."""
    ph = phase_mod.advance(gait.phase, params, dt)

    support_f = ph.support.to(feet_world.dtype)
    footprint_z = (feet_world[..., 2] * support_f).sum(-1) / torch.clamp(
        support_f.sum(-1), min=1.0)

    # Footholds are regenerated every tick for legs in swing and frozen
    # over the final 20% of the swing.
    if terrain is None:
        ground = 0.0
        normals = _set_z(torch.zeros_like(feet_world), 1.0)
    else:
        hips_3d = state.base.position[..., None, :] + quat_rotate(
            state.base.quaternion[..., None, :],
            model.hip_pos.to(feet_world.dtype))
        ground = terrain.height_at(hips_3d[..., :2])
    targets = raibert_footholds(
        model, state, params, v_desired_world, footprint_z,
        ground_height=ground, capture_gain=params.capture_gain,
        yaw_rate_desired=yaw_rate_desired,
    )
    if terrain is not None:
        targets, normals, _ = hf_mod.optimize_footholds(terrain, targets,
                                                        hips_3d)
    t_sw = params.t_swing[..., None]
    update = ph.ready_to_swing | (ph.is_swing
                                  & (ph.swing_phase < 0.8 * t_sw))
    new_targets = torch.where(update[..., None], targets, gait.swing_targets)
    new_starts = torch.where(ph.ready_to_swing[..., None], feet_world,
                             gait.swing_starts)

    # (Re)build swing splines from lift-off toward the current target,
    # knot times rescaled so the spline spans exactly t_swing.
    sp = swing_trajectory(new_starts, new_targets, profile=PROFILE_TRIANGLE,
                          profile_height=0.15)
    scale = t_sw / torch.clamp(sp.duration, min=1e-6)
    fresh = sp.replace(times=sp.times * scale[..., None],
                       tangents=sp.tangents / scale[..., None, None],
                       duration=t_sw.expand_as(sp.duration))
    old = gait.swing_splines
    splines = HermiteSpline(
        times=torch.where(update[..., None], fresh.times, old.times),
        values=torch.where(update[..., None, None], fresh.values, old.values),
        tangents=torch.where(update[..., None, None], fresh.tangents,
                             old.tangents),
        num_knots=torch.where(update, fresh.num_knots, old.num_knots),
        duration=torch.where(update, fresh.duration, old.duration),
    )
    pos = splines.evaluate(ph.swing_phase)
    vel = splines.velocity(ph.swing_phase)
    acc = splines.acceleration(ph.swing_phase)

    new_gait = GaitState(
        phase=ph, swing_splines=splines, swing_targets=new_targets,
        swing_starts=new_starts, base_ref_pos=gait.base_ref_pos,
        base_ref_vel=gait.base_ref_vel, yaw_ref=gait.yaw_ref,
    )
    target, ref_pos, ref_vel, yaw_ref = base_target_smoothed(
        model, state, new_gait, params, feet_world, v_desired_world,
        yaw_rate_desired, dt)
    new_gait = new_gait.replace(base_ref_pos=ref_pos, base_ref_vel=ref_vel,
                                yaw_ref=yaw_ref)
    return new_gait, ph.support, (pos, vel, acc), target, normals
