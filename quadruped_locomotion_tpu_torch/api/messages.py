"""Typed wire API: goal, feedback, result and robot-state messages (≙
``quadruped_locomotion_tpu/api/messages.py``, the reference's
``free_gait_msgs``).

The messages are plain host dataclasses with a lossless JSON round trip
(:func:`to_json` writes the same bytes as the JAX package for the same
message). :func:`goal_to_schedule` builds the goal's YAML-shaped motion
document on the host and compiles it through :mod:`.actions`, so the
schedule is made with numpy and moved to its device once;
:func:`robot_state_from_sim` snapshots a plant state into
:class:`RobotStateMsg` with one device-to-host copy.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ..planning.steps import StepSchedule
from . import actions as actions_mod

LEG_NAMES = ("LF_LEG", "RF_LEG", "RH_LEG", "LH_LEG")

# ExecuteSteps.action preempt modes (reference numeric values,
# free_gait_msgs/action/ExecuteSteps.action)
PREEMPT_IMMEDIATE = -1  # stop now, clear queue
PREEMPT_STEP = 0  # default: finish the active step, then stop
PREEMPT_NO = 1  # ignore stop requests

# feedback status values (ExecuteSteps.action feedback)
PROGRESS_PAUSED = -1
PROGRESS_UNKNOWN = 0
PROGRESS_EXECUTING = 1

# result status values (actionlib GoalStatus — the reference result
# says "see goal status")
RESULT_PREEMPTED = 2
RESULT_SUCCEEDED = 3
RESULT_ABORTED = 4


@dataclass
class FootstepMsg:
    """≙ free_gait_msgs/Footstep (all fields of the reference IDL)."""

    name: str  # LF_LEG / RF_LEG / RH_LEG / LH_LEG
    target: tuple[float, float, float] = (0.0, 0.0, 0.0)
    frame: str | None = None
    profile_type: str = "triangle"
    profile_height: float = 0.08
    average_velocity: float = 0.65
    surface_normal: tuple[float, float, float] | None = None
    ignore_contact: bool = False
    ignore_for_pose_adaptation: bool = False


@dataclass
class EndEffectorTargetMsg:
    """≙ free_gait_msgs/EndEffectorTarget (position target; the
    velocity/acceleration/force target arrays of the reference IDL are
    unused by its own stack — StepRosConverter only consumes
    target_position)."""

    name: str
    target_position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    frame: str | None = None
    average_velocity: float = 0.65
    surface_normal: tuple[float, float, float] | None = None
    ignore_contact: bool = False
    ignore_for_pose_adaptation: bool = False


@dataclass
class TrajectoryKnotMsg:
    """One knot of a cartesian / SE(3) trajectory (≙ one
    MultiDOFJointTrajectoryPoint)."""

    time: float = 0.0
    position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation_rpy: tuple[float, float, float] | None = None  # base only


@dataclass
class EndEffectorTrajectoryMsg:
    """≙ free_gait_msgs/EndEffectorTrajectory."""

    name: str
    knots: list[TrajectoryKnotMsg] = field(default_factory=list)
    frame: str | None = None
    surface_normal: tuple[float, float, float] | None = None
    ignore_contact: bool = False
    ignore_for_pose_adaptation: bool = False


@dataclass
class JointKnotMsg:
    """One knot of a per-joint trajectory (≙ JointTrajectoryPoint)."""

    time: float = 0.0
    positions: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass
class JointTargetMsg:
    """≙ free_gait_msgs/JointTarget: one joint-space target point,
    reached after ``duration`` (time_from_start of the reference's
    JointTrajectoryPoint)."""

    name: str
    positions: tuple[float, float, float] = (0.0, 0.0, 0.0)
    duration: float = 1.0
    surface_normal: tuple[float, float, float] | None = None
    ignore_contact: bool = False


@dataclass
class JointTrajectoryMsg:
    """≙ free_gait_msgs/JointTrajectory."""

    name: str
    knots: list[JointKnotMsg] = field(default_factory=list)
    surface_normal: tuple[float, float, float] | None = None
    ignore_contact: bool = False


@dataclass
class BaseAutoMsg:
    """≙ free_gait_msgs/BaseAuto."""

    height: float = 0.4
    average_linear_velocity: float = 0.2
    average_angular_velocity: float = 0.28
    ignore_timing_of_leg_motion: bool = False
    support_margin: float = 0.04


@dataclass
class BaseTargetMsg:
    """≙ free_gait_msgs/BaseTarget."""

    position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation_rpy: tuple[float, float, float] = (0.0, 0.0, 0.0)
    frame: str | None = None
    average_linear_velocity: float = 0.2
    average_angular_velocity: float = 0.28
    ignore_timing_of_leg_motion: bool = False


@dataclass
class BaseTrajectoryMsg:
    """≙ free_gait_msgs/BaseTrajectory (MultiDOFJointTrajectory knots)."""

    knots: list[TrajectoryKnotMsg] = field(default_factory=list)
    frame: str | None = None


@dataclass
class CustomCommandMsg:
    """≙ free_gait_msgs/CustomCommand: opaque command held for
    ``duration`` (the executor treats it as a stance hold, matching the
    reference's use as an adapter-specific pass-through)."""

    type: str = ""
    duration: float = 1.0
    command: str = ""


@dataclass
class StepMsg:
    """≙ free_gait_msgs/Step: per-limb motions (one type per leg) +
    optional base motion + custom commands — full Step.msg coverage."""

    id: str = ""
    footsteps: list[FootstepMsg] = field(default_factory=list)
    leg_modes: list["LegModeMsg"] = field(default_factory=list)
    end_effector_targets: list[EndEffectorTargetMsg] = field(
        default_factory=list
    )
    end_effector_trajectories: list[EndEffectorTrajectoryMsg] = field(
        default_factory=list
    )
    joint_targets: list[JointTargetMsg] = field(default_factory=list)
    joint_trajectories: list[JointTrajectoryMsg] = field(
        default_factory=list
    )
    base_auto: BaseAutoMsg | None = None
    base_target: BaseTargetMsg | None = None
    base_trajectory: BaseTrajectoryMsg | None = None
    custom_commands: list[CustomCommandMsg] = field(default_factory=list)


@dataclass
class ExecuteStepsGoal:
    """≙ ExecuteSteps.action goal."""

    steps: list[StepMsg] = field(default_factory=list)
    preempt: int = PREEMPT_STEP
    source_frame: str | None = None  # ≙ adapt_coordinates


@dataclass
class ExecuteStepsFeedback:
    """≙ ExecuteSteps.action feedback (all reference fields)."""

    step_id: str = ""
    step_number: int = 0  # 1-based within the current goal
    number_of_steps_in_goal: int = 0
    queue_size: int = 0  # remaining steps incl. the current one
    status: int = PROGRESS_EXECUTING
    description: str = ""
    duration: float = 0.0
    phase: float = 0.0  # 0-1 within the current step
    active_branches: list[str] = field(default_factory=list)


@dataclass
class ExecuteStepsResult:
    """≙ ExecuteSteps.action result (actionlib goal status)."""

    status: int = RESULT_SUCCEEDED
    goal_id: int = -1


@dataclass
class LegModeMsg:
    """≙ free_gait_msgs/LegMode: support flag + phase + surface normal.

    Doubles as a Step.msg leg motion (mode-switch with ``duration``) and
    a RobotState.msg per-leg status slot (``phase``), exactly like the
    reference's shared LegMode IDL."""

    support_leg: bool = True
    phase: float = 0.0
    name: str = ""
    surface_normal: tuple[float, float, float] = (0.0, 0.0, 1.0)
    duration: float = 0.0  # 0 → executor default
    ignore_for_pose_adaptation: bool = False


@dataclass
class RobotStateMsg:
    """≙ free_gait_msgs/RobotState: the /desired_robot_state payload."""

    base_position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    base_quaternion: tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    base_linear_velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    base_angular_velocity: tuple[float, float, float] = (0.0, 0.0, 0.0)
    joint_positions: list[list[float]] = field(
        default_factory=lambda: [[0.0] * 3 for _ in range(4)]
    )
    joint_velocities: list[list[float]] = field(
        default_factory=lambda: [[0.0] * 3 for _ in range(4)]
    )
    joint_efforts: list[list[float]] = field(
        default_factory=lambda: [[0.0] * 3 for _ in range(4)]
    )
    leg_modes: list[LegModeMsg] = field(
        default_factory=lambda: [LegModeMsg() for _ in range(4)]
    )


# ---------------------------------------------------------------------------
# serialization (the IDL-codegen replacement)
# ---------------------------------------------------------------------------

_MSG_TYPES = {
    c.__name__: c
    for c in (
        FootstepMsg,
        EndEffectorTargetMsg,
        EndEffectorTrajectoryMsg,
        TrajectoryKnotMsg,
        JointKnotMsg,
        JointTargetMsg,
        JointTrajectoryMsg,
        BaseAutoMsg,
        BaseTargetMsg,
        BaseTrajectoryMsg,
        CustomCommandMsg,
        StepMsg,
        ExecuteStepsGoal,
        ExecuteStepsFeedback,
        ExecuteStepsResult,
        LegModeMsg,
        RobotStateMsg,
    )
}


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__msg__": type(obj).__name__,
            **{
                f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_jsonable(obj):
    if isinstance(obj, dict) and "__msg__" in obj:
        cls = _MSG_TYPES[obj["__msg__"]]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in obj:
                v = _from_jsonable(obj[f.name])
                if isinstance(v, list) and f.type.startswith("tuple"):
                    v = tuple(v)
                kwargs[f.name] = v
        return cls(**kwargs)
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    return obj


def to_json(msg) -> str:
    return json.dumps(_to_jsonable(msg))


def from_json(s: str):
    return _from_jsonable(json.loads(s))


# ---------------------------------------------------------------------------
# goal → schedule (≙ StepRosConverter::fromMessage)
# ---------------------------------------------------------------------------


def goal_to_doc(goal: ExecuteStepsGoal) -> dict:
    """The goal as the YAML-shaped motion document that
    :func:`.actions.build_schedule` compiles (≙ ``StepRosConverter::
    fromMessage``)."""
    doc: dict = {"steps": []}
    if goal.source_frame:
        doc["adapt_coordinates"] = [
            {"transform": {"source_frame": goal.source_frame}}
        ]
    def common(m, spec):
        if spec.surface_normal is not None:
            m["surface_normal"] = list(spec.surface_normal)
        if spec.ignore_contact:
            m["ignore_contact"] = True
        if getattr(spec, "ignore_for_pose_adaptation", False):
            m["ignore_for_pose_adaptation"] = True

    for step in goal.steps:
        motions = []
        for fs in step.footsteps:
            m = {
                "name": fs.name,
                "profile_type": fs.profile_type,
                "profile_height": fs.profile_height,
                "average_velocity": fs.average_velocity,
                "target": {"position": list(fs.target)},
            }
            if fs.frame:
                m["target"]["frame"] = fs.frame
            common(m, fs)
            motions.append({"footstep": m})
        for lm in step.leg_modes:
            m = {
                "name": lm.name,
                "support_leg": lm.support_leg,
                "surface_normal": list(lm.surface_normal),
            }
            if lm.duration:
                m["duration"] = lm.duration
            if lm.ignore_for_pose_adaptation:
                m["ignore_for_pose_adaptation"] = True
            motions.append({"leg_mode": m})
        for et in step.end_effector_targets:
            m = {
                "name": et.name,
                "average_velocity": et.average_velocity,
                "target_position": {"position": list(et.target_position)},
            }
            if et.frame:
                m["target_position"]["frame"] = et.frame
            common(m, et)
            motions.append({"end_effector_target": m})
        for etr in step.end_effector_trajectories:
            m = {
                "name": etr.name,
                "trajectory": {
                    "knots": [
                        {"time": k.time, "position": list(k.position)}
                        for k in etr.knots
                    ]
                },
            }
            if etr.frame:
                m["frame"] = etr.frame
            common(m, etr)
            motions.append({"end_effector_trajectory": m})
        for jt in step.joint_targets:
            # JointTarget ≡ a single-knot joint trajectory reached at
            # `duration` (the reference's JointTrajectoryPoint
            # time_from_start).
            m = {
                "name": jt.name,
                "trajectory": {
                    "knots": [
                        {
                            "time": jt.duration,
                            "positions": list(jt.positions),
                        }
                    ]
                },
            }
            if jt.surface_normal is not None:
                m["surface_normal"] = list(jt.surface_normal)
            if jt.ignore_contact:
                m["ignore_contact"] = True
            motions.append({"joint_trajectory": m})
        for jtr in step.joint_trajectories:
            m = {
                "name": jtr.name,
                "trajectory": {
                    "knots": [
                        {"time": k.time, "positions": list(k.positions)}
                        for k in jtr.knots
                    ]
                },
            }
            if jtr.surface_normal is not None:
                m["surface_normal"] = list(jtr.surface_normal)
            if jtr.ignore_contact:
                m["ignore_contact"] = True
            motions.append({"joint_trajectory": m})
        if step.base_auto is not None:
            ba = step.base_auto
            motions.append(
                {
                    "base_auto": {
                        "height": ba.height,
                        "average_linear_velocity": ba.average_linear_velocity,
                        "average_angular_velocity": ba.average_angular_velocity,
                        "ignore_timing_of_leg_motion":
                            ba.ignore_timing_of_leg_motion,
                        "support_margin": ba.support_margin,
                    }
                }
            )
        elif step.base_target is not None:
            bt = step.base_target
            tgt = {
                "position": list(bt.position),
                "orientation": list(bt.orientation_rpy),
            }
            if bt.frame:
                tgt["frame"] = bt.frame
            motions.append(
                {
                    "base_target": {
                        "target": tgt,
                        "average_linear_velocity": bt.average_linear_velocity,
                        "average_angular_velocity": bt.average_angular_velocity,
                        "ignore_timing_of_leg_motion":
                            bt.ignore_timing_of_leg_motion,
                    }
                }
            )
        elif step.base_trajectory is not None:
            btr = step.base_trajectory
            knots = []
            for k in btr.knots:
                kn = {"time": k.time, "position": list(k.position)}
                if k.orientation_rpy is not None:
                    kn["orientation"] = list(k.orientation_rpy)
                knots.append(kn)
            m = {"trajectory": {"knots": knots}}
            if btr.frame:
                m["frame"] = btr.frame
            motions.append({"base_trajectory": m})
        for cc in step.custom_commands:
            motions.append(
                {
                    "custom_command": {
                        "type": cc.type,
                        "duration": cc.duration,
                        "command": cc.command,
                    }
                }
            )
        doc["steps"].append({"step": motions})

    return doc


def goal_to_schedule(goal: ExecuteStepsGoal, base_pos, base_quat, feet_world,
                     dtype=torch.float32, device=None) -> StepSchedule:
    """Compile an ExecuteStepsGoal into the executor's StepSchedule on
    ``device`` (default CUDA), resolving frames against the given robot
    state (≙ ``StepRosConverter::fromMessage`` feeding ``StepQueue::add``).
    The document and its arrays are built on the host, then moved."""
    return actions_mod.build_schedule(goal_to_doc(goal), base_pos, base_quat,
                                      feet_world, dtype, device)


def robot_state_from_sim(sim, support, phases=None) -> RobotStateMsg:
    """Snapshot one robot's plant state into the wire format (≙
    ``StateRosPublisher::publish``): the state's tensors are gathered on
    their device and copied to the host once."""
    robot = sim.robot
    base = robot.base
    parts = [base.position, base.quaternion, base.linear_velocity,
             base.angular_velocity, robot.q, robot.qd, robot.tau]
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
    h = flat.cpu().numpy().astype(np.float32)
    pos, quat, lin, ang = h[0:3], h[3:7], h[7:10], h[10:13]
    q, qd, tau = (h[13 + 12 * i:25 + 12 * i].reshape(4, 3) for i in range(3))
    phases = ([0.0] * 4 if phases is None
              else [float(x) for x in _host(phases)])
    sup = [bool(x) for x in _host(support)]
    return RobotStateMsg(
        base_position=tuple(pos.tolist()),
        base_quaternion=tuple(quat.tolist()),
        base_linear_velocity=tuple(lin.tolist()),
        base_angular_velocity=tuple(ang.tolist()),
        joint_positions=q.tolist(),
        joint_velocities=qd.tolist(),
        joint_efforts=tau.tolist(),
        leg_modes=[LegModeMsg(support_leg=sup[i], phase=phases[i],
                              name=LEG_NAMES[i]) for i in range(4)],
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
