"""YAML motion-script DSL → StepSchedule (≙ ``quadruped_locomotion_tpu/
api/actions.py``).

A motion script is a list of steps, each combining per-leg motions
(``footstep``, ``end_effector_target``, ``end_effector_trajectory``,
``joint_trajectory``, ``leg_mode``) with a base motion (``base_auto``,
``base_target``, ``base_trajectory``) and ``custom_command`` holds, in a
named source frame (``adapt_coordinates``: ``odom``/``world``,
``foot_print`` or ``base_link``) resolved against the robot's state at
load time. The schedule is built with numpy on the host and moved to its
device once. Orientations take 3 numbers (roll-pitch-yaw, radians) or 4
(an ``xyzw`` quaternion).
"""

from __future__ import annotations

import numpy as np
import torch
import yaml

from ..gait.footstep import (
    DEFAULT_AVERAGE_VELOCITY, DEFAULT_MIN_DURATION, DEFAULT_PROFILE_HEIGHT,
    PROFILE_SQUARE, PROFILE_STRAIGHT, PROFILE_TRAPEZOID, PROFILE_TRIANGLE,
)
from ..gait.spline import MAX_KNOTS
from ..planning.steps import (
    BASE_AUTO, BASE_NONE, BASE_TARGET, BASE_TRAJECTORY,
    DEFAULT_LEG_MODE_DURATION, LEG_EE_TARGET, LEG_EE_TRAJ, LEG_FOOTSTEP,
    LEG_JOINT_TRAJ, LEG_MODE, LEG_NONE, StepSchedule,
)
from ..types import resolve_device

LEG_NAMES = {"LF_LEG": 0, "RF_LEG": 1, "RH_LEG": 2, "LH_LEG": 3}
PROFILES = {
    "triangle": PROFILE_TRIANGLE,
    "square": PROFILE_SQUARE,
    "straight": PROFILE_STRAIGHT,
    "trapezoid": PROFILE_TRAPEZOID,
}


def _rpy_to_quat(rpy):
    r, p, y = [0.5 * v for v in rpy]
    cr, sr, cp, spp, cy, sy = (
        np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y),
    )
    return np.array([
        cr * cp * cy + sr * spp * sy,
        sr * cp * cy - cr * spp * sy,
        cr * spp * cy + sr * cp * sy,
        cr * cp * sy - sr * spp * cy,
    ])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _parse_orientation(o):
    """3 numbers → RPY radians; 4 numbers → an xyzw quaternion. Returns
    wxyz."""
    o = np.asarray(o, np.float64)
    if o.shape == (4,):
        x, y, z, w = o
        q = np.array([w, x, y, z])
        return q / np.linalg.norm(q)
    return _rpy_to_quat(o)


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _host(x):
    """A tensor or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class FrameAdapter:
    """Resolves script-frame coordinates to world at load time (frames:
    odom/world, foot_print, base_link)."""

    def __init__(self, base_pos, base_quat, feet_world):
        self.base_pos = _host(base_pos)
        self.base_quat = _host(base_quat)
        feet = _host(feet_world)
        center = feet.mean(axis=0)
        # footprint frame: the base's yaw, origin at the foot centroid
        w, x, y, z = self.base_quat
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        self.fp_origin = np.array([center[0], center[1], feet[:, 2].mean()])
        self.fp_quat = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])

    def position(self, p, frame):
        p = np.asarray(p, np.float64)
        if frame in ("odom", "world", None):
            return p
        if frame == "foot_print":
            return self.fp_origin + _quat_rotate(self.fp_quat, p)
        if frame == "base_link":
            return self.base_pos + _quat_rotate(self.base_quat, p)
        raise ValueError(f"unknown frame {frame!r}")

    def orientation(self, o, frame):
        q = _parse_orientation(o)
        if frame in ("odom", "world", None):
            return q
        if frame == "foot_print":
            return _quat_mul(self.fp_quat, q)
        if frame == "base_link":
            return _quat_mul(self.base_quat, q)
        raise ValueError(f"unknown frame {frame!r}")


def load_action(source: str, base_pos, base_quat, feet_world,
                dtype=torch.float32, device=None) -> StepSchedule:
    """Parse a YAML motion script (a path or inline text) into a
    StepSchedule on ``device`` (default CUDA), resolving frames against
    the given robot state (one robot: base (3,), (4,), feet (4,3))."""
    if "\n" not in source and source.endswith((".yaml", ".yml")):
        with open(source) as f:
            doc = yaml.safe_load(f)
    else:
        doc = yaml.safe_load(source)
    return build_schedule(doc, base_pos, base_quat, feet_world, dtype, device)


def _knots(kind, knots, K):
    if not 1 <= len(knots) <= K - 1:
        raise ValueError(f"{kind} needs 1..{K - 1} knots, got {len(knots)}")


def _pad_knots(arrays, index, n, K):
    """Repeat the last real knot into the padding (mask-safe)."""
    for a in arrays:
        for ki in range(n, K):
            a[index + (ki,)] = a[index + (n - 1,)]


def build_schedule(doc: dict, base_pos, base_quat, feet_world,
                   dtype=torch.float32, device=None) -> StepSchedule:
    """Compile a parsed motion-script document to a StepSchedule on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    default_frame = None
    for tr in doc.get("adapt_coordinates", []) or []:
        t = tr.get("transform", {})
        default_frame = t.get("source_frame", default_frame)

    adapter = FrameAdapter(base_pos, base_quat, feet_world)
    steps = doc["steps"]
    S, K = len(steps), MAX_KNOTS

    leg_type = np.full((S, 4), LEG_NONE, np.int32)
    leg_target = np.zeros((S, 4, 3), np.float64)
    leg_profile = np.full((S, 4), PROFILE_TRIANGLE, np.int32)
    leg_ph = np.full((S, 4), DEFAULT_PROFILE_HEIGHT, np.float64)
    leg_av = np.full((S, 4), DEFAULT_AVERAGE_VELOCITY, np.float64)
    leg_ic = np.zeros((S, 4), bool)
    leg_ipa = np.zeros((S, 4), bool)
    leg_sup = np.ones((S, 4), bool)
    leg_norm = np.tile(np.array([0.0, 0.0, 1.0]), (S, 4, 1))
    leg_md = np.full((S, 4), DEFAULT_LEG_MODE_DURATION, np.float64)
    jt_t = np.zeros((S, 4, K), np.float64)
    jt_p = np.zeros((S, 4, K, 3), np.float64)
    jt_n = np.full((S, 4), 2, np.int32)
    base_mode = np.full((S,), BASE_NONE, np.int32)
    base_height = np.full((S,), 0.4, np.float64)
    base_tp = np.zeros((S, 3), np.float64)
    base_tq = np.tile(np.array([1.0, 0, 0, 0]), (S, 1))
    base_al = np.full((S,), 0.2, np.float64)
    base_aa = np.full((S,), 0.28, np.float64)
    base_it = np.zeros((S,), bool)
    base_margin = np.full((S,), 0.04, np.float64)
    bk_t = np.zeros((S, K), np.float64)
    bk_p = np.zeros((S, K, 3), np.float64)
    bk_q = np.tile(np.array([1.0, 0, 0, 0]), (S, K, 1))
    bk_n = np.full((S,), 2, np.int32)
    min_dur = np.full((S,), DEFAULT_MIN_DURATION, np.float64)

    def leg_common(si, leg, spec):
        leg_ic[si, leg] = bool(spec.get("ignore_contact", False))
        leg_ipa[si, leg] = bool(spec.get("ignore_for_pose_adaptation", False))
        # the target surface normal (every leg-motion message carries one)
        if spec.get("surface_normal") is not None:
            leg_norm[si, leg] = spec["surface_normal"]

    for si, entry in enumerate(steps):
        motions = entry.get("step", entry if isinstance(entry, list) else [])
        for m in motions:
            if "footstep" in m:
                fs = m["footstep"]
                leg = LEG_NAMES[fs["name"]]
                tgt = fs.get("target", {})
                frame = tgt.get("frame", default_frame)
                leg_type[si, leg] = LEG_FOOTSTEP
                leg_target[si, leg] = adapter.position(
                    tgt.get("position", [0, 0, 0]), frame)
                leg_profile[si, leg] = PROFILES.get(
                    str(fs.get("profile_type", "triangle")), PROFILE_TRIANGLE)
                leg_ph[si, leg] = fs.get("profile_height",
                                         DEFAULT_PROFILE_HEIGHT)
                leg_av[si, leg] = fs.get("average_velocity",
                                         DEFAULT_AVERAGE_VELOCITY)
                leg_common(si, leg, fs)
            elif "end_effector_target" in m:
                et = m["end_effector_target"]
                leg = LEG_NAMES[et["name"]]
                tgt = et.get("target_position", et.get("target", {}))
                frame = tgt.get("frame", default_frame)
                leg_type[si, leg] = LEG_EE_TARGET
                leg_target[si, leg] = adapter.position(
                    tgt.get("position", [0, 0, 0]), frame)
                leg_profile[si, leg] = PROFILE_STRAIGHT
                leg_av[si, leg] = et.get("average_velocity",
                                         DEFAULT_AVERAGE_VELOCITY)
                leg_common(si, leg, et)
            elif "end_effector_trajectory" in m:
                et = m["end_effector_trajectory"]
                leg = LEG_NAMES[et["name"]]
                knots = et.get("trajectory", {}).get("knots", [])
                _knots("end_effector_trajectory", knots, K)
                frame = et.get("frame", default_frame)
                leg_type[si, leg] = LEG_EE_TRAJ
                jt_n[si, leg] = len(knots)
                for ki, kn in enumerate(knots):
                    jt_t[si, leg, ki] = kn["time"]
                    jt_p[si, leg, ki] = adapter.position(
                        kn.get("position", [0, 0, 0]), frame)
                _pad_knots((jt_t, jt_p), (si, leg), len(knots), K)
                # the final stance foothold is the last knot
                leg_target[si, leg] = jt_p[si, leg, len(knots) - 1]
                leg_common(si, leg, et)
            elif "joint_trajectory" in m:
                jt = m["joint_trajectory"]
                leg = LEG_NAMES[jt["name"]]
                knots = jt.get("trajectory", {}).get("knots", [])
                _knots("joint_trajectory", knots, K)
                leg_type[si, leg] = LEG_JOINT_TRAJ
                jt_n[si, leg] = len(knots)
                for ki, kn in enumerate(knots):
                    jt_t[si, leg, ki] = kn["time"]
                    jt_p[si, leg, ki] = kn["positions"]
                _pad_knots((jt_t, jt_p), (si, leg), len(knots), K)
                leg_common(si, leg, jt)
            elif "leg_mode" in m:
                lm = m["leg_mode"]
                leg = LEG_NAMES[lm["name"]]
                leg_type[si, leg] = LEG_MODE
                leg_sup[si, leg] = bool(lm.get("support_leg", True))
                leg_norm[si, leg] = lm.get("surface_normal", [0, 0, 1])
                leg_md[si, leg] = lm.get("duration", DEFAULT_LEG_MODE_DURATION)
                leg_common(si, leg, lm)
            elif "base_auto" in m:
                ba = m["base_auto"] or {}
                base_mode[si] = BASE_AUTO
                base_height[si] = ba.get("height", 0.4)
                base_al[si] = ba.get("average_linear_velocity", 0.2)
                base_aa[si] = ba.get("average_angular_velocity", 0.28)
                base_it[si] = bool(ba.get("ignore_timing_of_leg_motion", False))
                # an explicit 0.0 is kept; the default applies only when absent
                base_margin[si] = ba.get("support_margin", 0.04)
            elif "base_target" in m:
                bt = m["base_target"]
                tgt = bt.get("target", {})
                frame = tgt.get("frame", default_frame)
                base_mode[si] = BASE_TARGET
                base_tp[si] = adapter.position(tgt.get("position", [0, 0, 0]),
                                               frame)
                base_tq[si] = adapter.orientation(
                    tgt.get("orientation", [0, 0, 0]), frame)
                base_al[si] = bt.get("average_linear_velocity", 0.2)
                base_aa[si] = bt.get("average_angular_velocity", 0.28)
                base_it[si] = bool(bt.get("ignore_timing_of_leg_motion", False))
            elif "base_trajectory" in m:
                btr = m["base_trajectory"]
                knots = btr.get("trajectory", {}).get("knots", [])
                _knots("base_trajectory", knots, K)
                frame = btr.get("frame", default_frame)
                base_mode[si] = BASE_TRAJECTORY
                bk_n[si] = len(knots)
                for ki, kn in enumerate(knots):
                    bk_t[si, ki] = kn["time"]
                    bk_p[si, ki] = adapter.position(
                        kn.get("position", [0, 0, 0]), frame)
                    bk_q[si, ki] = adapter.orientation(
                        kn.get("orientation", [0, 0, 0]), frame)
                _pad_knots((bk_t, bk_p, bk_q), (si,), len(knots), K)
            elif "custom_command" in m:
                # opaque adapter commands: here a hold for `duration`
                cc = m["custom_command"] or {}
                min_dur[si] = max(min_dur[si], float(cc.get("duration", 1.0)))

    f = lambda x: torch.as_tensor(np.asarray(x), device=dev).to(dtype)  # noqa: E731
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)  # noqa: E731
    return StepSchedule(
        leg_motion_type=t(leg_type), leg_target=f(leg_target),
        leg_profile=t(leg_profile), leg_profile_height=f(leg_ph),
        leg_avg_velocity=f(leg_av), leg_ignore_contact=t(leg_ic),
        leg_ignore_pose_adapt=t(leg_ipa), leg_support_flag=t(leg_sup),
        leg_surface_normal=f(leg_norm), leg_mode_duration=f(leg_md),
        knot_times=f(jt_t), knot_values=f(jt_p), knot_n=t(jt_n),
        base_mode=t(base_mode), base_height=f(base_height),
        base_target_pos=f(base_tp), base_target_quat=f(base_tq),
        base_avg_lin=f(base_al), base_avg_ang=f(base_aa),
        base_ignore_timing=t(base_it), base_margin=f(base_margin),
        base_knot_times=f(bk_t), base_knot_pos=f(bk_p),
        base_knot_quat=f(bk_q), base_nknots=t(bk_n), min_duration=f(min_dur),
    )
