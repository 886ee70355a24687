"""Closed-loop execution of step schedules: scripted motion (≙
``quadruped_locomotion_tpu/rollout/script_loop.py``).

Each 100 Hz planner tick advances the step executor once, then
``CONTROL_SUBSTEPS`` 400 Hz substeps run the contact FSM, the balance
controller (``locomotion_update``: its QP through the generic IPM, as in
the JAX package, not the kernel), the joint PID of joint-mode legs, the
lost-contact freeze and the massless plant. State may carry leading
batch dims (one robot per schedule is ``()``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..control.contact_fsm import (
    FsmState, apply_swing_reflexes, fsm_step, init_fsm_state,
)
from ..control.locomotion import ControllerParams, locomotion_update
from ..control.swing import joint_pd_gravity_torques, joint_pid_gravity_torques
from ..planning import steps as steps_mod
from ..types import RobotModel, TensorStruct, full_f32_matmuls, resolve_device
from . import simulator as simlib
from .closed_loop import CONTROL_DT, CONTROL_SUBSTEPS, PLANNER_DT

# Normalizer of the post-touchdown stance phase of scripted footsteps:
# the FSM thresholds are defined on the gait's normalized stance phase,
# and scripts have no stance timer, so the reference trot's stance time.
SCRIPT_STANCE_NORM = 0.45


@dataclass
class ScriptState(TensorStruct):
    sim: simlib.SimState
    exec: steps_mod.ExecState
    fsm: FsmState
    joint_i: torch.Tensor  # (...,4,3) joint-PID integral


def init_script_state(model: RobotModel, sched=None, height: float = 0.4,
                      device=None, sim=None) -> ScriptState:
    """A standing start for one robot on ``device`` (default CUDA; raises
    where it is absent), or, given ``sim``, the start of a new schedule
    from that plant state: a fresh executor, FSM and PID integral, as the
    JAX console starts each action of a collection. ``sched`` is unused,
    as in the JAX package."""
    dev = resolve_device(device)
    model = model.to(dev)
    if sim is None:
        sim = simlib.default_stance_state(model, height=height)
    es = steps_mod.init_exec_state(sim.feet_world, sim.robot.base.position,
                                   sim.robot.base.quaternion)
    return ScriptState(sim=sim, exec=es,
                       fsm=init_fsm_state((), dev, sim.feet_world.dtype),
                       joint_i=torch.zeros_like(sim.feet_world))


def planner_tick(model: RobotModel, params: ControllerParams,
                 sched: steps_mod.StepSchedule, ss: ScriptState,
                 qp_iters: int = 15, active_steps=None, dt=PLANNER_DT):
    """One planner tick + the control substeps. ``active_steps`` and
    ``dt`` as in ``steps.advance`` (``dt = 0``: a pause tick, the
    controller keeps running on the held outputs). Returns (new
    ScriptState, max QP KKT over the substeps (...))."""
    return _planner_tick(model, params, sched, ss, qp_iters, active_steps,
                         dt)[:2]


def _planner_tick(model, params, sched, ss, qp_iters, active_steps, dt):
    """planner_tick, also returning the executor's outputs."""
    robot = ss.sim.robot
    es2, out = steps_mod.advance(
        model, sched, ss.exec, ss.sim.feet_world, robot.base.position,
        robot.base.quaternion, dt, q_now=robot.q, active_steps=active_steps)
    support = out.support
    # Normalized swing phase: time since this leg's motion began over its
    # own duration (the base-shift phase does not count).
    tl = es2.time_in_step[..., None] - es2.leg_start[..., None]
    leg_dur = torch.clamp(es2.leg_duration, min=1e-3)
    sw_norm = torch.where(es2.leg_active, torch.clamp(tl / leg_dur, 0.0, 1.0),
                          torch.zeros_like(leg_dur))
    # Normalized stance phase: the executor's cross-step stance clock over
    # the reference trot's stance time.
    st_norm = torch.clamp(es2.leg_stance_time / SCRIPT_STANCE_NORM, 0.0, 1.0)
    # only footstep legs engage the reflexes; sticky across steps
    is_footstep = es2.leg_last_motion == steps_mod.LEG_FOOTSTEP

    sim, fsm_state, joint_i = ss.sim, ss.fsm, ss.joint_i
    kkt = None
    for _ in range(CONTROL_SUBSTEPS):
        contact = simlib.contact_sensor(sim)
        fsm_state, fsm = fsm_step(fsm_state, support, contact, sw_norm,
                                  st_norm, sim.robot.q,
                                  is_footstep=is_footstep)
        # joint-mode legs bypass the contact FSM
        fsm_support = torch.where(out.joint_mode, support, fsm.support)
        pos_r, vel_r, acc_r = apply_swing_reflexes(
            out.foot_pos, out.foot_vel, out.foot_acc, sim.feet_world, fsm)
        state = sim.robot.replace(support=fsm_support,
                                  surface_normal=out.surface_normal)
        tau, diag = locomotion_update(model, params, state, out.base, pos_r,
                                      vel_r, acc_r, qp_iters=qp_iters)
        # joint-mode legs: PID + gravity compensation; the integral resets
        # whenever the leg is not in joint mode
        joint_active = (out.joint_mode & ~fsm_support)[..., None]
        tau_joint, joint_i2 = joint_pid_gravity_torques(
            model, state, out.q_des, out.qd_des, joint_i, CONTROL_DT)
        joint_i = torch.where(joint_active, joint_i2, torch.zeros_like(joint_i2))
        tau = torch.where(joint_active, tau_joint, tau)
        # lost-contact freeze reflex
        tau_freeze = joint_pd_gravity_torques(
            model, state, fsm.q_freeze, torch.zeros_like(fsm.q_freeze))
        tau = torch.where(fsm.freeze[..., None], tau_freeze, tau)
        sim = simlib.step(model, sim, tau, CONTROL_DT, support=fsm_support)
        k = diag.distribution.qp_solution.kkt_error
        kkt = k if kkt is None else torch.maximum(kkt, k)
    return (ScriptState(sim=sim, exec=es2, fsm=fsm_state, joint_i=joint_i),
            kkt, out)


def run_schedule(model: RobotModel, params: ControllerParams,
                 sched: steps_mod.StepSchedule, ss0: ScriptState,
                 planner_steps: int, qp_iters: int = 15, device=None):
    """Roll the schedule for ``planner_steps`` ticks on ``device``
    (default CUDA; raises where it is absent). Returns (final state,
    telemetry): a dict of per-tick stacked tensors with the JAX package's
    keys (``base_position``, ``base_quaternion``, ``feet_world``,
    ``joint_positions``, ``step_index``, ``done``, ``qp_kkt``) plus the
    executor's desired ``support``."""
    dev = resolve_device(device)
    full_f32_matmuls()
    model, params, sched, ss = (o.to(dev) for o in (model, params, sched, ss0))
    tel = {k: [] for k in ("base_position", "base_quaternion", "feet_world",
                           "joint_positions", "step_index", "done", "qp_kkt",
                           "support")}
    for _ in range(planner_steps):
        ss, kkt, out = _planner_tick(model, params, sched, ss, qp_iters, None,
                                     PLANNER_DT)
        robot = ss.sim.robot
        for k, v in (("base_position", robot.base.position),
                     ("base_quaternion", robot.base.quaternion),
                     ("feet_world", ss.sim.feet_world),
                     ("joint_positions", robot.q),
                     ("step_index", ss.exec.step_index),
                     ("done", ss.exec.done), ("qp_kkt", kkt),
                     ("support", out.support)):
            tel[k].append(v)
    return ss, {k: torch.stack(v) for k, v in tel.items()}
