"""Batched closed-loop locomotion rollout: gait → control → physics (≙
``quadruped_locomotion_tpu/rollout/closed_loop.py`` with ``batched=True``).

Each 100 Hz planner tick runs the gait engine once, then
``CONTROL_SUBSTEPS`` 400 Hz control + physics substeps. Every substep
runs the contact FSM and the controller's prepare stage for all
scenarios, ONE batched force-distribution QP solve (the CUDA kernel on
the GPU), the finish stage, and one plant step. Every input carries a
leading scenario axis B. The scenario axis may also vary the gait
(per-scenario ``GaitParams``, e.g. a trot/pace mix from
:func:`init_locomotion_mixed`) and the terrain (a ``Heightfield`` with
one map per scenario): the config-5 scenario surface, terrain × gait ×
velocity.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..control.contact_fsm import (
    FsmState, apply_swing_reflexes, fsm_step, init_fsm_state,
)
from ..control.force_distribution import solve_formed_qp_batched
from ..control.locomotion import (
    ControllerParams, locomotion_finish, locomotion_prepare,
)
from ..control.swing import joint_pd_gravity_torques
from ..gait import gait_generator as gg
from ..gait import phase as phase_mod
from ..gait.phase import GaitParams
from ..model.kinematics import foot_velocities, forward_kinematics
from ..types import (
    BaseTarget, RobotModel, TensorStruct, full_f32_matmuls, resolve_device,
    where_tree,
)
from ..utils import logging as qlog
from ..utils.cuda_graphs import Graphed
from ..utils.rotations import cross, quat_rotate
from . import articulated as artlib
from . import simulator as simlib
from .simulator import SimState

PLANNER_DT = 0.01  # 100 Hz
CONTROL_SUBSTEPS = 4  # → 400 Hz control/physics
CONTROL_DT = PLANNER_DT / CONTROL_SUBSTEPS


def _no_plant_step(model, sim, tau, dt, **kw):
    """Controller-only "plant": the state stays (epsilon-)frozen; the
    1e-9·tanh term ties the next state to this tick's torques."""
    eps = 1e-9 * torch.tanh(tau.mean(dim=(-2, -1)))
    base = sim.robot.base
    return sim.replace(robot=sim.robot.replace(
        base=base.replace(position=base.position + eps[..., None])))


# "articulated" (the default): the fully coupled 18-DoF floating-base
# plant (rollout/articulated.py), one launch of its CUDA kernel a step on
# the card and the plain PyTorch step elsewhere. "massless": trunk +
# swing-leg plant (rollout/simulator.py). "none": controller only.
PLANTS = {"articulated": artlib.step, "massless": simlib.step,
          "none": _no_plant_step}


def measured_foot_speed_tangential(model: RobotModel, robot) -> torch.Tensor:
    """(...,4) world-frame tangential foot speeds from measured kinematics
    (feeds the FSM's slip detection)."""
    v_rel_b = foot_velocities(model, robot.q, robot.qd)
    r_b = forward_kinematics(model, robot.q)
    w = robot.base.angular_velocity[..., None, :]
    v_w = robot.base.linear_velocity[..., None, :] + quat_rotate(
        robot.base.quaternion[..., None, :], cross(w, r_b) + v_rel_b)
    return torch.linalg.norm(v_w[..., :2], dim=-1)


@dataclass
class LocomotionState(TensorStruct):
    sim: SimState
    gait: gg.GaitState
    fsm: FsmState


@dataclass
class Command(TensorStruct):
    """Velocity command per scenario."""

    linear_velocity: torch.Tensor  # (B,3) world/footprint frame
    yaw_rate: torch.Tensor  # (B,)


def init_locomotion(
    model: RobotModel,
    gait_params: GaitParams,
    batch: int,
    gait_type: int = 0,
    height: float | None = None,
    device=None,
) -> LocomotionState:
    """A standing start for ``batch`` scenarios on ``device`` (default
    CUDA; raises where it is absent)."""
    dev = resolve_device(device)
    model, gait_params = model.to(dev), gait_params.to(dev)
    h = float(gait_params.height) if height is None else height
    sim = simlib.default_stance_state(model, height=h, batch=(batch,))
    gait = gg.init_gait_state(gait_type, gait_params, sim.feet_world)
    return LocomotionState(sim=sim, gait=gait,
                           fsm=init_fsm_state((batch,), dev,
                                              sim.feet_world.dtype))


def init_locomotion_mixed(
    model: RobotModel,
    gait_params: GaitParams,  # per-scenario leaves (B,) / (B,2)
    gait_type: torch.Tensor,  # (B,) phase.TROT / phase.PACE
    height: float | None = None,
    device=None,
) -> LocomotionState:
    """Standing starts of a mixed-gait batch on ``device`` (default CUDA;
    raises where it is absent): each scenario stands at its own
    ``GaitParams.height`` and takes its gait's init table
    (where-selected, so the batch stays one fixed-shape state)."""
    dev = resolve_device(device)
    gait_type = torch.as_tensor(gait_type, device=dev)
    B = gait_type.shape[0]
    model, gait_params = model.to(dev), gait_params.to(dev).per_scenario(B)
    h = gait_params.height if height is None else height
    sim = simlib.default_stance_state(model, height=h, batch=(B,))
    trot = gg.init_gait_state(phase_mod.TROT, gait_params, sim.feet_world)
    pace = gg.init_gait_state(phase_mod.PACE, gait_params, sim.feet_world)
    gait = where_tree(gait_type == phase_mod.PACE, pace, trot)
    return LocomotionState(sim=sim, gait=gait,
                           fsm=init_fsm_state((B,), dev, sim.feet_world.dtype))


class SubstepInputs(NamedTuple):
    """What a substep's controller and plant take besides the controller's
    state: handed to a ``telemetry_fn`` as its fifth argument where
    :func:`planner_tick` is asked for it (``telemetry_inputs=True``)."""

    target: BaseTarget  # the gait engine's base target for the VMC
    sim: SimState  # the plant's state: the pinned set in sim.robot.support,
    # the pinned feet's anchors in sim.feet_world
    ground_height: torch.Tensor  # (B,4) the ground under sim.feet_world


def _stack(trees: list):
    """Stack a list of same-layout trees (tensors, dicts, dataclasses,
    NamedTuples) leaf by leaf along a new leading axis."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.stack(trees)
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)})
    if isinstance(t0, tuple):
        return type(t0)(*(_stack(list(v)) for v in zip(*trees)))
    raise TypeError(f"cannot stack {type(t0)!r}")


def _contact_stage(model, terrain, sim, fsm_state, support, sw_norm,
                   st_norm, pos_w, vel_w, acc_w, normals):
    """A substep's contact sensing, FSM and swing reflexes: (ground
    height under each foot, FSM state, FSM output, reflexed swing
    references, the controller's robot state)."""
    gz = (torch.zeros_like(sim.feet_world[..., 2]) if terrain is None
          else terrain.height_at(sim.feet_world[..., :2]))
    # reconcile the gait's support with measured contact, then reflexes
    contact = simlib.contact_sensor(sim, ground_height=gz)
    fsm_state, fsm = fsm_step(
        fsm_state, support, contact, sw_norm, st_norm, sim.robot.q,
        foot_speed_tangential=measured_foot_speed_tangential(model, sim.robot),
    )
    pos_r, vel_r, acc_r = apply_swing_reflexes(
        pos_w, vel_w, acc_w, sim.feet_world, fsm, ground_height=gz)
    state = sim.robot.replace(support=fsm.support, surface_normal=normals)
    return gz, fsm_state, fsm, pos_r, vel_r, acc_r, state


def _finish_stage(model, params, state, ctx, sol, q_freeze, freeze):
    """The QP's forces to torques, with the lost-contact freeze reflex
    (hold the posture stored at loss): (torques, diagnostics)."""
    tau, diag = locomotion_finish(model, params, state, ctx, sol)
    tau_freeze = joint_pd_gravity_torques(model, state, q_freeze,
                                          torch.zeros_like(q_freeze))
    return torch.where(freeze[..., None], tau_freeze, tau), diag


# The substep's stages, each replayed from a CUDA graph on the card
# (utils/cuda_graphs.py); the QP's one kernel launch stays eager.
STAGES = {"contact": Graphed(_contact_stage),
          "prepare": Graphed(locomotion_prepare),
          "finish": Graphed(_finish_stage)}


def _plant(plant: str):
    if plant not in PLANTS:
        raise ValueError(f"unknown plant {plant!r}")
    return PLANTS[plant]


def planner_tick(
    model: RobotModel,
    params: ControllerParams,
    gait_params: GaitParams,
    ls: LocomotionState,
    command: Command,
    qp_iters: int = 15,
    terrain=None,
    plant: str = "articulated",
    friction_mu: float | None = None,
    qp_backend: str = "auto",
    telemetry_fn=None,
    telemetry_inputs: bool = False,
):
    """One 100 Hz planner tick + 4 control/physics substeps over the batch.
    ``terrain``: a ``Heightfield`` with one map per scenario (None is
    flat ground at z = 0). ``friction_mu`` (articulated plant only)
    bounds contact forces by the Coulomb cone. Returns (new
    LocomotionState, per-scenario max QP KKT over the substeps (B,)).
    ``telemetry_fn(state, tau, diag, ctx) -> tree``, if given, collects
    per-substep extras (the controller's state, the applied torques, the
    balance diagnostics and the formed QP of each substep); the second
    result is then (kkt, extras stacked over the substeps). With
    ``telemetry_inputs`` it is called with a fifth argument, the
    substep's :class:`SubstepInputs` (the plant's whole input with
    ``tau`` and ``state.support``).

    Spans: the tick is ``loop.tick``, the gait engine
    ``loop.gait_advance``; each substep's ``loop.contact_fsm`` (contact
    sensor, FSM, reflexes), ``loop.prepare``, ``loop.qp``,
    ``loop.finish`` (with the freeze reflex), ``loop.record`` (the
    ``telemetry_fn`` call, where one is given) and ``loop.plant`` carry
    ``substep`` 0-3.

    On the card the contact, prepare and finish stages are replayed from
    CUDA graphs (:data:`STAGES`), captured at their first call; the
    articulated plant is one launch of its kernel (``articulated.step``);
    the gait engine, the QP and the ``telemetry_fn`` run eagerly."""
    plant_step = _plant(plant)
    contact, prepare, finish = (STAGES[k]
                                for k in ("contact", "prepare", "finish"))
    plant_kwargs = ({"friction_mu": friction_mu}
                    if friction_mu is not None and plant == "articulated"
                    else {})
    with qlog.span("loop.tick"):
        with qlog.span("loop.gait_advance"):
            gait2, support, (pos_w, vel_w, acc_w), target, normals = (
                gg.advance(model, ls.gait, ls.sim.robot, ls.sim.feet_world,
                           gait_params, command.linear_velocity,
                           command.yaw_rate, PLANNER_DT, terrain=terrain))
        # normalized phases for the FSM thresholds
        sw_norm = gait2.phase.swing_phase / torch.clamp(
            gait_params.t_swing[..., None], min=1e-6)
        st_norm = gait2.phase.stance_phase / torch.clamp(
            gait_params.t_stance[..., None], min=1e-6)

        sim, fsm_state = ls.sim, ls.fsm
        kkt = None
        extras = []
        for i in range(CONTROL_SUBSTEPS):
            with qlog.span("loop.contact_fsm", substep=i):
                gz, fsm_state, fsm, pos_r, vel_r, acc_r, state = contact(
                    (model, terrain), sim, fsm_state, support, sw_norm,
                    st_norm, pos_w, vel_w, acc_w, normals)
            with qlog.span("loop.prepare", substep=i):
                ctx = prepare((model, params), state, target,
                              pos_r, vel_r, acc_r)
            with qlog.span("loop.qp", substep=i):
                sol = solve_formed_qp_batched(ctx.G, ctx.g, ctx.D, ctx.d,
                                              iters=qp_iters,
                                              backend=qp_backend)
            with qlog.span("loop.finish", substep=i):
                tau, diag = finish((model, params), state, ctx, sol,
                                   fsm.q_freeze, fsm.freeze)
            if telemetry_fn is not None:
                with qlog.span("loop.record", substep=i):
                    args = (state, tau, diag, ctx)
                    if telemetry_inputs:
                        args += (SubstepInputs(target, sim, gz),)
                    extras.append(telemetry_fn(*args))
            with qlog.span("loop.plant", substep=i):
                sim = plant_step(model, sim, tau, CONTROL_DT,
                                 support=fsm.support, ground_height=gz,
                                 **plant_kwargs)
            k = sol.kkt_error
            kkt = k if kkt is None else torch.maximum(kkt, k)
    out = LocomotionState(sim=sim, gait=gait2, fsm=fsm_state)
    if telemetry_fn is None:
        return out, kkt
    return out, (kkt, _stack(extras))


def rollout(
    model: RobotModel,
    params: ControllerParams,
    gait_params: GaitParams,
    ls0: LocomotionState,
    command: Command,
    planner_steps: int,
    qp_iters: int = 15,
    terrain=None,
    plant: str = "articulated",
    friction_mu: float | None = None,
    qp_backend: str = "auto",
    device=None,
    telemetry_fn=None,
):
    """Batched closed-loop rollout on ``device`` (default CUDA; raises
    where it is absent). ``gait_params`` shared or per scenario,
    ``terrain`` None (flat) or one ``Heightfield`` map per scenario.
    Returns (final state, telemetry): a dict of (T, B, ...) tensors, one
    entry per planner tick. With ``telemetry_fn`` (see
    :func:`planner_tick`) the dict also holds ``extras``, leaves
    (T, substeps, B, ...)."""
    dev = resolve_device(device)
    full_f32_matmuls()
    _plant(plant)
    model, params, gait_params, ls, command = (
        o.to(dev) for o in (model, params, gait_params, ls0, command))
    gait_params = gait_params.per_scenario(ls.sim.feet_world.shape[0])
    if terrain is not None:
        terrain = terrain.to(dev)
    tel = {k: [] for k in ("base_position", "base_quaternion",
                           "base_velocity", "feet_world", "support",
                           "leg_state", "qp_kkt")}
    extras = []
    for _ in range(planner_steps):
        ls, tick_out = planner_tick(
            model, params, gait_params, ls, command, qp_iters=qp_iters,
            terrain=terrain, plant=plant, friction_mu=friction_mu,
            qp_backend=qp_backend, telemetry_fn=telemetry_fn,
        )
        kkt = tick_out if telemetry_fn is None else tick_out[0]
        if telemetry_fn is not None:
            extras.append(tick_out[1])
        base = ls.sim.robot.base
        tel["base_position"].append(base.position)
        tel["base_quaternion"].append(base.quaternion)
        tel["base_velocity"].append(base.linear_velocity)
        tel["feet_world"].append(ls.sim.feet_world)
        tel["support"].append(ls.gait.phase.support)
        tel["leg_state"].append(ls.fsm.leg_state)
        tel["qp_kkt"].append(kkt)
    out = {k: torch.stack(v) for k, v in tel.items()}
    if telemetry_fn is not None:
        out["extras"] = _stack(extras)
    return ls, out
