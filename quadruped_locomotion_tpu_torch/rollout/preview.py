"""Kinematic preview of a step schedule (≙ ``quadruped_locomotion_tpu/
rollout/preview.py``): the step executor run against an ideal plant
(swing feet follow their splines, stance feet stay pinned, the base
tracks the planner's pose; joints by IK, joint-mode legs by their joint
splines and FK), recorded tick by tick into a :class:`StateBatch` with
the StateBatchComputer-style post-processors. No physics, no balance QP:
a tick costs the executor's spline evaluations, plus the pose cascade's
QPs on ticks that enter a base_auto step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..model.kinematics import forward_kinematics, inverse_kinematics
from ..planning import steps as steps_mod
from ..types import RobotModel, TensorStruct, full_f32_matmuls, resolve_device
from ..utils.rotations import quat_inv_rotate, quat_normalize, quat_rotate
from . import simulator as simlib
from .closed_loop import PLANNER_DT


@dataclass
class StateBatch(TensorStruct):
    """Recorded preview time series (leading axis = planner tick, then
    the executor's batch dims)."""

    times: torch.Tensor  # (T,)
    base_position: torch.Tensor  # (T,...,3) world
    base_quaternion: torch.Tensor  # (T,...,4) wxyz
    joint_positions: torch.Tensor  # (T,...,4,3)
    feet_world: torch.Tensor  # (T,...,4,3)
    feet_velocity: torch.Tensor  # (T,...,4,3) world
    support: torch.Tensor  # (T,...,4) bool
    step_index: torch.Tensor  # (T,...) int32
    done: torch.Tensor  # (T,...) bool

    @property
    def num_ticks(self) -> int:
        return self.times.shape[0]


RECORDED = ("base_position", "base_quaternion", "joint_positions",
            "feet_world", "feet_velocity", "support", "step_index", "done")


def preview_step(model: RobotModel, sched: steps_mod.StepSchedule,
                 es: steps_mod.ExecState, feet, bpos, bquat,
                 dt: float = PLANNER_DT):
    """One preview tick: the executor's tick, then the ideal plant.
    Returns (es, feet, bpos, bquat, the tick's record of RECORDED)."""
    es, out = steps_mod.advance(model, sched, es, feet, bpos, bquat, dt)
    support = out.support[..., None]
    feet2 = torch.where(support, feet, out.foot_pos)
    bpos = out.base.position
    bquat = quat_normalize(out.base.quaternion)
    # joints: IK of foot-in-base at the new pose; joint-mode legs follow
    # their joint splines and their feet the resulting FK
    q4 = bquat[..., None, :].expand(feet2.shape[:-1] + (4,))
    q = inverse_kinematics(model, quat_inv_rotate(q4, feet2 - bpos[..., None, :]))
    jm = out.joint_mode[..., None]
    q = torch.where(jm, out.q_des, q)
    fk = bpos[..., None, :] + quat_rotate(q4, forward_kinematics(model, q))
    feet = torch.where(jm, fk, feet2)
    rec = dict(base_position=bpos, base_quaternion=bquat, joint_positions=q,
               feet_world=feet,
               feet_velocity=torch.where(support, torch.zeros_like(out.foot_vel),
                                         out.foot_vel),
               support=out.support, step_index=es.step_index, done=es.done)
    return es, feet, bpos, bquat, rec


def batch_preview(
    model: RobotModel,
    sched: steps_mod.StepSchedule,
    feet_world0: torch.Tensor,  # (...,4,3)
    base_pos0: torch.Tensor,  # (...,3)
    base_quat0: torch.Tensor,  # (...,4)
    planner_ticks: int,
    dt: float = PLANNER_DT,
) -> StateBatch:
    """Run the step executor kinematically for ``planner_ticks`` ticks and
    record every tick (on the device of the inputs)."""
    es = steps_mod.init_exec_state(feet_world0, base_pos0, base_quat0)
    feet, bpos, bquat = feet_world0, base_pos0, base_quat0
    recs = {k: [] for k in RECORDED}
    for _ in range(planner_ticks):
        es, feet, bpos, bquat, rec = preview_step(model, sched, es, feet,
                                                  bpos, bquat, dt)
        for k, v in rec.items():
            recs[k].append(v)
    times = (1 + torch.arange(planner_ticks, dtype=feet_world0.dtype,
                              device=feet_world0.device)) * dt
    return StateBatch(times=times, **{k: torch.stack(v) for k, v in recs.items()})


def preview_schedule(
    model: RobotModel,
    sched: steps_mod.StepSchedule,
    height: float = 0.4,
    planner_ticks: int | None = None,
    dt: float = PLANNER_DT,
    device=None,
) -> StateBatch:
    """Preview a schedule from the default stance on ``device`` (default
    CUDA; raises where it is absent). ``planner_ticks`` defaults to ~4 s
    per step."""
    dev = resolve_device(device)
    full_f32_matmuls()
    model, sched = model.to(dev), sched.to(dev)
    sim = simlib.default_stance_state(model, height=height)
    if planner_ticks is None:
        planner_ticks = int(sched.num_steps * 4.0 / dt)
    return batch_preview(model, sched, sim.feet_world,
                         sim.robot.base.position, sim.robot.base.quaternion,
                         planner_ticks, dt=dt)


# ---------------------------------------------------------------------------
# StateBatchComputer equivalents + scrubbing (one executor: no batch dims)
# ---------------------------------------------------------------------------


def state_at(batch: StateBatch, t) -> dict:
    """The recorded batch at wall time ``t``: continuous quantities
    interpolated linearly between the neighbouring ticks, discrete ones
    from the earlier tick."""
    times = batch.times
    t = torch.clamp(torch.as_tensor(t, dtype=times.dtype, device=times.device),
                    times[0], times[-1])
    hi = torch.clamp(torch.searchsorted(times, t), 1, times.shape[0] - 1)
    lo = hi - 1
    w = (t - times[lo]) / torch.clamp(times[hi] - times[lo], min=1e-9)

    def lerp(x):
        return (1.0 - w) * x[lo] + w * x[hi]

    return {
        "base_position": lerp(batch.base_position),
        "base_quaternion": quat_normalize(lerp(batch.base_quaternion)),
        "joint_positions": lerp(batch.joint_positions),
        "feet_world": lerp(batch.feet_world),
        "support": batch.support[lo],
        "step_index": batch.step_index[lo],
    }


def compute_end_effector_trajectories(batch: StateBatch):
    """(times, per-leg swing positions), NaN while the leg is in support."""
    swing = torch.where(batch.support[..., None],
                        torch.full_like(batch.feet_world, float("nan")),
                        batch.feet_world)
    return batch.times, swing


def compute_stances(batch: StateBatch) -> torch.Tensor:
    """(T,4,3): row t repeats the footholds at the latest change of the
    support set (tick 0 counts as one)."""
    sup = batch.support
    changed = (sup != torch.roll(sup, 1, dims=0)).any(-1)
    changed[0] = True
    # index of the latest change at or before each tick
    ticks = torch.arange(sup.shape[0], device=sup.device)
    last = torch.cummax(torch.where(changed, ticks, torch.zeros_like(ticks)),
                        dim=0).values
    return batch.feet_world[last]


def compute_base_trajectory(batch: StateBatch):
    """(times, positions, quaternions) of the torso path."""
    return batch.times, batch.base_position, batch.base_quaternion
