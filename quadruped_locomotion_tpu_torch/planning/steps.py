"""Step schedules and their executor (≙ ``quadruped_locomotion_tpu/
planning/steps.py``).

A motion script compiles to a fixed-shape :class:`StepSchedule` (stacked
per-step tensors, leading axis = step), and :func:`advance` moves an
:class:`ExecState` by one planner tick:

* step entry (:func:`_enter_step`): swing splines from the current feet
  toward the step's targets with the step's profiles, knot splines for
  joint and end-effector trajectories seeded with the current value, and
  the base motion (``base_auto`` runs the pose-optimization cascade over
  the step's final stance, ``base_target`` takes the given pose,
  ``base_trajectory`` fits a multi-knot SE(3) curve);
* every tick evaluates the swing splines and the base's SE(3) curve;
* a finished step advances the index; past the end the executor holds
  the final stance.

Leg-motion codes: ``LEG_FOOTSTEP`` (profiled swing), ``LEG_EE_TARGET``
(straight move of the end effector, held with ``ignore_contact``),
``LEG_JOINT_TRAJ`` (joint-space knots, the leg under joint PID),
``LEG_MODE`` (support switch with a surface normal and duration) and
``LEG_EE_TRAJ`` (cartesian knots).

The schedule is shared; an :class:`ExecState` may carry leading batch
dims (one executor per instance, e.g. ``()`` for one robot). The step
entry runs only on ticks where some instance switches (a host-side read
of the switch mask); the JAX package computes it every tick and keeps it
through a ``jnp.where`` only where the step switches, so the values are
the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..gait import spline as spline_mod
from ..gait.footstep import (
    DEFAULT_AVERAGE_VELOCITY, DEFAULT_MIN_DURATION, DEFAULT_PROFILE_HEIGHT,
    PROFILE_TRIANGLE, fma_norm, swing_trajectory,
)
from ..gait.spline import MAX_KNOTS, HermiteSpline
from ..types import BaseTarget, RobotModel, TensorStruct, resolve_device
from ..utils.rotations import quat_conj, quat_exp, quat_log, quat_mul, quat_normalize
from . import pose_optimization as po

# Base-motion modes
BASE_NONE = 0
BASE_AUTO = 1
BASE_TARGET = 2
BASE_TRAJECTORY = 3

# Leg-motion types
LEG_NONE = 0
LEG_FOOTSTEP = 1
LEG_EE_TARGET = 2
LEG_JOINT_TRAJ = 3
LEG_MODE = 4
LEG_EE_TRAJ = 5

DEFAULT_BASE_AVG_LIN = 0.2  # BaseAuto's average linear velocity
DEFAULT_BASE_AVG_ANG = 0.28
DEFAULT_LEG_MODE_DURATION = 0.5


def _cartesian(m):
    return (m == LEG_FOOTSTEP) | (m == LEG_EE_TARGET) | (m == LEG_EE_TRAJ)


@dataclass
class StepSchedule(TensorStruct):
    """Stacked per-step specs; leading axis = step index."""

    # leg motions
    leg_motion_type: torch.Tensor  # (S,4) int32 LEG_* codes
    leg_target: torch.Tensor  # (S,4,3) world foothold / EE targets
    leg_profile: torch.Tensor  # (S,4) int32 footstep profiles
    leg_profile_height: torch.Tensor  # (S,4)
    leg_avg_velocity: torch.Tensor  # (S,4)
    leg_ignore_contact: torch.Tensor  # (S,4) bool
    leg_ignore_pose_adapt: torch.Tensor  # (S,4) bool
    leg_support_flag: torch.Tensor  # (S,4) bool (LEG_MODE target support)
    leg_surface_normal: torch.Tensor  # (S,4,3) world (LEG_MODE)
    leg_mode_duration: torch.Tensor  # (S,4)
    # trajectory knots padded to MAX_KNOTS: joint positions
    # (LEG_JOINT_TRAJ) or world foot positions (LEG_EE_TRAJ)
    knot_times: torch.Tensor  # (S,4,K)
    knot_values: torch.Tensor  # (S,4,K,3)
    knot_n: torch.Tensor  # (S,4) int32
    # base motion
    base_mode: torch.Tensor  # (S,) int32
    base_height: torch.Tensor  # (S,) nominal height for base_auto
    base_target_pos: torch.Tensor  # (S,3) world (base_target)
    base_target_quat: torch.Tensor  # (S,4) wxyz (base_target)
    base_avg_lin: torch.Tensor  # (S,)
    base_avg_ang: torch.Tensor  # (S,)
    base_ignore_timing: torch.Tensor  # (S,) bool: legs and base together
    base_margin: torch.Tensor  # (S,) support-polygon margin
    # base trajectory knots (BASE_TRAJECTORY); the entry pose is prepended
    base_knot_times: torch.Tensor  # (S,K)
    base_knot_pos: torch.Tensor  # (S,K,3)
    base_knot_quat: torch.Tensor  # (S,K,4)
    base_nknots: torch.Tensor  # (S,) int32
    min_duration: torch.Tensor  # (S,) step-level minimum duration

    @property
    def num_steps(self) -> int:
        return self.leg_motion_type.shape[0]

    @property
    def leg_active(self) -> torch.Tensor:
        """Legs with a cartesian swing motion per step (S,4)."""
        return _cartesian(self.leg_motion_type)

    @classmethod
    def create(cls, num_steps: int, dtype=torch.float32, device=None,
               **overrides) -> "StepSchedule":
        """A schedule of reference defaults on ``device`` (default CUDA),
        any subset of fields overridden (leg motions default to LEG_NONE,
        base motions to BASE_NONE)."""
        dev = resolve_device(device)
        S, K = num_steps, MAX_KNOTS
        i32 = dict(dtype=torch.int32, device=dev)
        f = dict(dtype=dtype, device=dev)
        b = dict(dtype=torch.bool, device=dev)
        ez = torch.tensor([0.0, 0.0, 1.0], **f)
        unit = torch.tensor([1.0, 0.0, 0.0, 0.0], **f)
        defaults = dict(
            leg_motion_type=torch.zeros(S, 4, **i32),
            leg_target=torch.zeros(S, 4, 3, **f),
            leg_profile=torch.full((S, 4), PROFILE_TRIANGLE, **i32),
            leg_profile_height=torch.full((S, 4), DEFAULT_PROFILE_HEIGHT, **f),
            leg_avg_velocity=torch.full((S, 4), DEFAULT_AVERAGE_VELOCITY, **f),
            leg_ignore_contact=torch.zeros(S, 4, **b),
            leg_ignore_pose_adapt=torch.zeros(S, 4, **b),
            leg_support_flag=torch.ones(S, 4, **b),
            leg_surface_normal=ez.repeat(S, 4, 1),
            leg_mode_duration=torch.full((S, 4), DEFAULT_LEG_MODE_DURATION,
                                         **f),
            knot_times=torch.zeros(S, 4, K, **f),
            knot_values=torch.zeros(S, 4, K, 3, **f),
            knot_n=torch.full((S, 4), 2, **i32),
            base_mode=torch.zeros(S, **i32),
            base_height=torch.full((S,), 0.4, **f),
            base_target_pos=torch.zeros(S, 3, **f),
            base_target_quat=unit.repeat(S, 1),
            base_avg_lin=torch.full((S,), DEFAULT_BASE_AVG_LIN, **f),
            base_avg_ang=torch.full((S,), DEFAULT_BASE_AVG_ANG, **f),
            base_ignore_timing=torch.zeros(S, **b),
            base_margin=torch.full((S,), 0.04, **f),
            base_knot_times=torch.zeros(S, K, **f),
            base_knot_pos=torch.zeros(S, K, 3, **f),
            base_knot_quat=unit.repeat(S, K, 1),
            base_nknots=torch.full((S,), 2, **i32),
            min_duration=torch.full((S,), DEFAULT_MIN_DURATION, **f),
        )
        unknown = set(overrides) - set(defaults)
        if unknown:
            raise TypeError(f"unknown StepSchedule fields: {sorted(unknown)}")
        defaults.update({k: torch.as_tensor(v, device=dev).to(defaults[k].dtype)
                         for k, v in overrides.items()})
        return cls(**defaults)


class ExecOutputs(NamedTuple):
    """Per-tick executor outputs: the planner → controller interface."""

    support: torch.Tensor  # (...,4) bool
    foot_pos: torch.Tensor  # (...,4,3) world swing references
    foot_vel: torch.Tensor  # (...,4,3)
    foot_acc: torch.Tensor  # (...,4,3)
    joint_mode: torch.Tensor  # (...,4) bool: leg under joint-space control
    q_des: torch.Tensor  # (...,4,3) joint targets (joint-mode legs)
    qd_des: torch.Tensor  # (...,4,3)
    surface_normal: torch.Tensor  # (...,4,3) world
    base: BaseTarget


@dataclass
class ExecState(TensorStruct):
    """Executor bookkeeping; leading dims are the batch (may be none)."""

    step_index: torch.Tensor  # (...) int32
    time_in_step: torch.Tensor  # (...)
    step_duration: torch.Tensor  # (...)
    base_duration: torch.Tensor  # (...)
    leg_start: torch.Tensor  # (...) when the leg motions begin
    leg_duration: torch.Tensor  # (...,4) per-leg motion durations
    leg_motion: torch.Tensor  # (...,4) int32 LEG_* codes this step
    leg_ignore_contact: torch.Tensor  # (...,4) bool
    leg_support_flag: torch.Tensor  # (...,4) bool (LEG_MODE)
    leg_surface_normal: torch.Tensor  # (...,4,3)
    splines: HermiteSpline  # cartesian swing splines (...,4,K)
    joint_splines: HermiteSpline  # joint-space splines (...,4,K)
    base_spline: HermiteSpline  # base position over 0..base_duration (...,K)
    base_quat_knots: torch.Tensor  # (...,K,4)
    done: torch.Tensor  # (...) bool: schedule exhausted
    # Sticky per-leg mode channel: the last non-NONE motion type each
    # leg executed (the controller's is_footstep persists across steps).
    leg_last_motion: torch.Tensor  # (...,4) int32
    # seconds each leg has been in desired support (the FSM's stance clock)
    leg_stance_time: torch.Tensor  # (...,4)

    @property
    def leg_active(self) -> torch.Tensor:
        """Legs with a cartesian swing motion this step (...,4)."""
        return _cartesian(self.leg_motion)


def _empty_splines(values):
    """Degenerate 2-knot splines holding ``values`` (...,3)."""
    vals = values[..., None, :].expand(values.shape[:-1] + (MAX_KNOTS, 3))
    lead = values.shape[:-1]
    return HermiteSpline(
        times=values.new_zeros(lead + (MAX_KNOTS,)),
        values=vals.clone(),
        tangents=torch.zeros_like(vals),
        num_knots=torch.full(lead, 2, dtype=torch.int32, device=values.device),
        duration=values.new_zeros(lead),
    )


def init_exec_state(feet_world, base_pos, base_quat) -> ExecState:
    """Before the first tick (which enters step 0): feet (...,4,3), base
    position (...,3) and quaternion (...,4)."""
    lead = base_pos.shape[:-1]
    dev = base_pos.device
    i32 = dict(dtype=torch.int32, device=dev)
    normal = feet_world.new_tensor([0.0, 0.0, 1.0])
    return ExecState(
        step_index=torch.full(lead, -1, **i32),
        time_in_step=torch.full_like(base_pos[..., 0], float("inf")),
        step_duration=base_pos.new_zeros(lead),
        base_duration=base_pos.new_zeros(lead),
        leg_start=base_pos.new_zeros(lead),
        leg_duration=feet_world.new_zeros(lead + (4,)),
        leg_motion=torch.zeros(lead + (4,), **i32),
        leg_ignore_contact=torch.zeros(lead + (4,), dtype=torch.bool,
                                       device=dev),
        leg_support_flag=torch.ones(lead + (4,), dtype=torch.bool, device=dev),
        leg_surface_normal=normal.expand(lead + (4, 3)).clone(),
        splines=_empty_splines(feet_world),
        joint_splines=_empty_splines(torch.zeros_like(feet_world)),
        base_spline=_empty_splines(base_pos),
        base_quat_knots=base_quat[..., None, :].expand(
            lead + (MAX_KNOTS, 4)).clone(),
        done=torch.zeros(lead, dtype=torch.bool, device=dev),
        leg_last_motion=torch.zeros(lead + (4,), **i32),
        leg_stance_time=torch.full_like(feet_world[..., 0], 10.0),  # deep stance
    )


def _gather_knots(a, src):
    """a (...,K) or (...,K,C) at knot indices src (...,K)."""
    if a.dim() == src.dim():
        return torch.gather(a, -1, src)
    return torch.gather(a, -2, src[..., None].expand(src.shape + a.shape[-1:]))


def _prepend(times, values, nknots, v_now):
    """Knots with (0, v_now) prepended, padded past the last real knot
    by repeating it: (times (...,K), values (...,K,C), count (...))."""
    t = torch.cat([torch.zeros_like(times[..., :1]),
                   times[..., :MAX_KNOTS - 1]], dim=-1)
    v = torch.cat([v_now[..., None, :], values[..., :MAX_KNOTS - 1, :]],
                  dim=-2)
    k = torch.clamp(nknots + 1, max=MAX_KNOTS)
    last = torch.clamp(k.long() - 1, 0, MAX_KNOTS - 1)
    src = torch.minimum(torch.arange(MAX_KNOTS, device=t.device),
                        last[..., None])
    return _gather_knots(t, src), _gather_knots(v, src), k


def _fit_knot_spline(times, pos, nknots, v_now):
    """Knot trajectories (joint- or task-space 3-vectors): Hermite
    through the script's knots with the current value prepended at t = 0,
    zero end velocities."""
    t, v, k = _prepend(times, pos, nknots, v_now)
    zero = torch.zeros_like(v_now)
    return spline_mod.fit(t, v, zero, zero, k.to(torch.int32))


def _quat_segment_eval(times, quats, num_knots, t, duration):
    """Piecewise quaternion interpolation over the knot times: a
    smoothstep of the exp/log geodesic per segment. times (...,K), quats
    (...,K,4), num_knots (...), t (...), duration (...)."""
    idx = torch.arange(MAX_KNOTS, device=t.device)
    valid = idx < (num_knots.long() - 1)[..., None]
    t0k = times[..., 0]
    t = torch.minimum(torch.maximum(t, t0k), torch.maximum(t0k, duration))
    seg = (valid & (times <= t[..., None])).sum(-1) - 1
    seg = torch.clamp(seg, 0, MAX_KNOTS - 2)[..., None]
    t0 = torch.gather(times, -1, seg)[..., 0]
    t1 = torch.gather(times, -1, seg + 1)[..., 0]
    h_raw = t1 - t0
    ok = h_raw > 1e-6
    h = torch.where(ok, h_raw, torch.ones_like(h_raw))
    u = torch.clamp((t - t0) / h, 0.0, 1.0)
    s = 3 * u**2 - 2 * u**3
    sdot = torch.where(ok, (6 * u - 6 * u**2) / h, torch.zeros_like(u))
    q0 = _gather_knots(quats, seg)[..., 0, :]
    q1 = _gather_knots(quats, seg + 1)[..., 0, :]
    phi = quat_log(quat_mul(quat_conj(q0), q1))
    q = quat_normalize(quat_mul(q0, quat_exp(s[..., None] * phi)))
    q = torch.where(ok[..., None], q, q0)
    angvel = torch.where(ok[..., None], sdot[..., None] * phi,
                         torch.zeros_like(phi))
    return q, angvel


def _where(mask, a, b):
    """``a`` where ``mask`` (leading dims of a) else ``b``, leaf by leaf
    over two splines or tensors."""
    if isinstance(a, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)
    return HermiteSpline(*(_where(mask, x, y) for x, y in zip(
        (a.times, a.values, a.tangents, a.num_knots, a.duration),
        (b.times, b.values, b.tangents, b.num_knots, b.duration))))


def _enter_step(model: RobotModel, sched: StepSchedule, idx, feet_world,
                base_pos, base_quat, q_now, need_pose=None):
    """Resolve step ``idx`` (...) from the current state (the step
    completer). ``idx`` is clamped into the schedule, so a past-the-end
    index (an instance that does not switch) reads the last step, whose
    result the caller discards. ``need_pose`` (...) bool marks the
    instances whose base_auto pose is kept; None means every one."""
    i = torch.clamp(idx.long(), 0, sched.num_steps - 1)
    mtype = sched.leg_motion_type[i]
    eetraj = mtype == LEG_EE_TRAJ
    cartesian = _cartesian(mtype)
    jointspace = mtype == LEG_JOINT_TRAJ
    legmode = mtype == LEG_MODE
    targets = sched.leg_target[i]

    splines = swing_trajectory(
        feet_world, targets, profile=sched.leg_profile[i],
        profile_height=sched.leg_profile_height[i],
        average_velocity=sched.leg_avg_velocity[i])
    # end_effector_trajectory legs: Hermite through the cartesian knots
    knot_t, knot_v, knot_n = (sched.knot_times[i], sched.knot_values[i],
                              sched.knot_n[i])
    splines = _where(eetraj, _fit_knot_spline(knot_t, knot_v, knot_n,
                                              feet_world), splines)
    # inactive legs: degenerate hold-position splines
    splines = _where(cartesian, splines, _empty_splines(feet_world))
    joint_splines = _where(jointspace,
                           _fit_knot_spline(knot_t, knot_v, knot_n, q_now),
                           _empty_splines(q_now))
    zero = torch.zeros_like(splines.duration)
    leg_dur = torch.where(
        cartesian, splines.duration,
        torch.where(jointspace, joint_splines.duration,
                    torch.where(legmode, sched.leg_mode_duration[i], zero)))

    # final stance of this step: cartesian legs at their targets
    final_feet = torch.where(cartesian[..., None], targets, feet_world)

    mode = sched.base_mode[i]
    ignore_pa = sched.leg_ignore_pose_adapt[i]
    auto = mode == BASE_AUTO
    if need_pose is not None:
        auto = auto & need_pose
    if bool(auto.any()):
        # base_auto: nominal-stance cost over the final stance, CoM in the
        # polygon of the legs that keep support during the motion (margin
        # from the step), limb lengths at both stances; legs flagged
        # ignore_for_pose_adaptation leave both lists.
        moving = cartesian | jointspace
        keeps_support = torch.where(legmode, sched.leg_support_flag[i], ~moving)
        auto_pose = po.optimize_pose(
            model, final_feet, ~ignore_pa, height=sched.base_height[i],
            margin=sched.base_margin[i], polygon_feet=feet_world,
            polygon_support=keeps_support & ~ignore_pa,
            limb_feet=torch.cat([final_feet, feet_world], dim=-2),
            limb_support=torch.cat([~ignore_pa | cartesian,
                                    torch.ones_like(ignore_pa)], dim=-1))
        auto_pos, auto_quat = auto_pose
    else:
        # no instance keeps a base_auto pose: the JAX package computes one
        # and discards it through the jnp.where below
        auto_pos, auto_quat = base_pos, base_quat
    is_target = (mode == BASE_TARGET)[..., None]
    is_auto = (mode == BASE_AUTO)[..., None]
    pos1 = torch.where(is_target, sched.base_target_pos[i],
                       torch.where(is_auto, auto_pos, base_pos))
    quat1 = torch.where(is_target, sched.base_target_quat[i],
                        torch.where(is_auto, auto_quat, base_quat))

    # --- base curve: a K-knot Hermite + quaternion knots
    # (a move whose duration lands on a planner tick ends on the tick the
    # reference's rounding gives, see footstep.fma_norm)
    lin_dist = fma_norm(pos1 - base_pos)
    ang_dist = fma_norm(quat_log(quat_mul(quat_conj(base_quat), quat1)))
    two_knot_dur = torch.where(
        mode == BASE_NONE, torch.zeros_like(lin_dist),
        torch.maximum(lin_dist / sched.base_avg_lin[i],
                      ang_dist / sched.base_avg_ang[i]))
    is_traj = mode == BASE_TRAJECTORY
    # trajectory knots with the current pose prepended at t = 0
    tt, pp, nk_traj = _prepend(sched.base_knot_times[i],
                               sched.base_knot_pos[i], sched.base_nknots[i],
                               base_pos)
    _, qq, _ = _prepend(sched.base_knot_times[i], sched.base_knot_quat[i],
                        sched.base_nknots[i], base_quat)
    # the two-knot curve (NONE/AUTO/TARGET): [now → target] over its duration
    first = torch.arange(MAX_KNOTS, device=tt.device) == 0
    t2 = torch.where(first, torch.zeros_like(tt), two_knot_dur[..., None])
    p2 = torch.where(first[:, None], base_pos[..., None, :], pos1[..., None, :])
    q2 = torch.where(first[:, None], base_quat[..., None, :],
                     quat1[..., None, :])
    kt = torch.where(is_traj[..., None], tt, t2)
    kp = torch.where(is_traj[..., None, None], pp, p2)
    kq = torch.where(is_traj[..., None, None], qq, q2)
    nk = torch.where(is_traj, nk_traj, torch.full_like(nk_traj, 2))
    zero3 = torch.zeros_like(base_pos)
    base_spline = spline_mod.fit(kt, kp, zero3, zero3, nk.to(torch.int32))
    base_dur = base_spline.duration

    # Two-phase timing: unless the script sets ignore_timing_of_leg_motion
    # the base shift completes first, then the leg motions start.
    any_leg = (mtype != LEG_NONE).any(-1)
    leg_start = torch.where(any_leg & ~sched.base_ignore_timing[i], base_dur,
                            torch.zeros_like(base_dur))
    duration = torch.maximum(leg_start + leg_dur.amax(-1),
                             torch.maximum(base_dur, sched.min_duration[i]))
    return dict(
        leg_motion=mtype, leg_duration=leg_dur,
        leg_ignore_contact=sched.leg_ignore_contact[i],
        leg_support_flag=sched.leg_support_flag[i],
        leg_surface_normal=sched.leg_surface_normal[i],
        splines=splines, joint_splines=joint_splines,
        base_spline=base_spline, base_quat_knots=kq, base_duration=base_dur,
        leg_start=leg_start, duration=duration,
    )


def advance(model: RobotModel, sched: StepSchedule, es: ExecState,
            feet_world, base_pos, base_quat, dt, q_now=None,
            active_steps=None):
    """One planner tick. Returns (new ExecState, :class:`ExecOutputs`).

    ``q_now`` (...,4,3) seeds joint trajectories at step entry (zeros by
    default). ``active_steps`` (≤ ``sched.num_steps``) is the number of
    live leading schedule rows. ``dt == 0`` is a pause tick: time stands
    still, no step switches, the outputs repeat."""
    dtype = feet_world.dtype
    if q_now is None:
        q_now = torch.zeros_like(feet_world)
    active = sched.num_steps if active_steps is None else active_steps
    dt = float(dt)

    # --- step switching
    t = es.time_in_step + dt
    finished = t >= es.step_duration
    next_idx = es.step_index + 1
    live = next_idx < active
    switch = finished & live & ~es.done & (dt > 0)
    done = es.done | (finished & ~live & (dt > 0))

    w = switch
    if bool(switch.any()):
        entered = _enter_step(model, sched, next_idx, feet_world, base_pos,
                              base_quat, q_now, need_pose=switch)
        sel = lambda a, b: _where(w, a, b)  # noqa: E731
        es2 = ExecState(
            step_index=torch.where(w, next_idx, es.step_index),
            time_in_step=torch.where(w, torch.full_like(t, dt), t),
            step_duration=sel(entered["duration"], es.step_duration),
            base_duration=sel(entered["base_duration"], es.base_duration),
            leg_start=sel(entered["leg_start"], es.leg_start),
            leg_duration=sel(entered["leg_duration"], es.leg_duration),
            leg_motion=sel(entered["leg_motion"], es.leg_motion),
            leg_ignore_contact=sel(entered["leg_ignore_contact"],
                                   es.leg_ignore_contact),
            leg_support_flag=sel(entered["leg_support_flag"],
                                 es.leg_support_flag),
            leg_surface_normal=sel(entered["leg_surface_normal"],
                                   es.leg_surface_normal),
            splines=sel(entered["splines"], es.splines),
            joint_splines=sel(entered["joint_splines"], es.joint_splines),
            base_spline=sel(entered["base_spline"], es.base_spline),
            base_quat_knots=sel(entered["base_quat_knots"], es.base_quat_knots),
            done=done,
            leg_last_motion=torch.where(
                w[..., None] & (entered["leg_motion"] != LEG_NONE),
                entered["leg_motion"], es.leg_last_motion),
            leg_stance_time=es.leg_stance_time,  # updated below
        )
    else:
        es2 = es.replace(time_in_step=t, done=done)

    tt = es2.time_in_step
    mtype = es2.leg_motion
    cartesian = es2.leg_active
    jointspace = mtype == LEG_JOINT_TRAJ
    legmode = mtype == LEG_MODE

    # --- leg motions, delayed past the base shift. Past the end of the
    # schedule time keeps growing (inf before the first step): every
    # window is over and every spline clamps to its end.
    tl = tt[..., None] - es2.leg_start[..., None]
    in_window = (tl >= 0.0) & (tl < es2.leg_duration)
    in_swing = cartesian & in_window
    tle = torch.clamp(tl, min=0.0)
    pos, vel, acc = es2.splines.derivatives(tle)
    zero = torch.zeros_like(pos)
    # ignore-contact legs hold their spline for the whole step (parked
    # in the air with stiffness rather than sagging)
    track = in_swing | (cartesian & es2.leg_ignore_contact)
    pos = torch.where(track[..., None], pos, feet_world)
    vel = torch.where(in_swing[..., None], vel, zero)
    acc = torch.where(in_swing[..., None], acc, zero)

    # joint-space channel: hold the last knot after the motion window
    joint_mode = jointspace & (tl >= 0.0)
    q_des, qd_des = es2.joint_splines.derivatives(tle, 2)
    qd_des = torch.where(in_window[..., None], qd_des, zero)

    # --- support set: a moving leg is non-support in its window, an
    # ignore-contact leg for the whole step, a leg_mode leg per its flag
    moving = cartesian | jointspace
    nonsupport = ((moving & in_window) | (moving & es2.leg_ignore_contact)
                  | (legmode & (tl >= 0.0) & ~es2.leg_support_flag))
    support = ~nonsupport
    up = feet_world.new_tensor([0.0, 0.0, 1.0])
    normal = torch.where(legmode[..., None], es2.leg_surface_normal,
                         up.expand_as(es2.leg_surface_normal))

    # --- base motion: the K-knot SE(3) curve
    tb = torch.minimum(torch.maximum(tt, torch.zeros_like(tt)),
                       es2.base_duration)
    bs = es2.base_spline
    b_quat, b_angvel = _quat_segment_eval(
        bs.times, es2.base_quat_knots, bs.num_knots, tb, es2.base_duration)
    b_pos, b_vel = bs.derivatives(tb, 2)
    target = BaseTarget(position=b_pos, quaternion=b_quat,
                        linear_velocity=b_vel, angular_velocity=b_angvel)
    # stance clock: grows while the leg is desired support, resets in swing
    es2 = es2.replace(leg_stance_time=torch.where(
        support, es2.leg_stance_time + dt,
        torch.zeros_like(es2.leg_stance_time)))
    out = ExecOutputs(support=support, foot_pos=pos, foot_vel=vel,
                      foot_acc=acc, joint_mode=joint_mode, q_des=q_des,
                      qd_des=qd_des, surface_normal=normal, base=target)
    return es2, out
