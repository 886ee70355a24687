"""URDF robot-description loader -> :class:`RobotModel` (≙
``quadruped_locomotion_tpu/model/urdf.py``).

A dependency-free URDF parser (links with inertials, joints with
origins, axes, limits and dynamics) and a chain extractor that maps a
4×3-DoF quadruped description onto the analytic leg convention

    haa (Rz) → Rx(-π/2) → hfe (Rz) → (l1, 0, d) → kfe (Rz) → (l2, 0, 0) → foot

Parsing is numpy on the host; the model's tensors are made once on the
requested device. :data:`SIMPLEDOG_URDF` is the port's copy of the
bundled ``assets/simpledog.urdf``; it round-trips to
:meth:`RobotModel.simpledog`.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..types import DEFAULT_LIMB_CONFIG, IK_BRANCH, RobotModel, resolve_device

SIMPLEDOG_URDF = str(Path(__file__).resolve().parents[1] / "assets"
                     / "simpledog.urdf")

# canonical leg order (TypeDefs.hpp LimbEnum): LF, RF, RH, LH —
# identified from hip-origin signs (+x+y, +x-y, -x-y, -x+y).
_LEG_SIGNS = ((1, 1), (1, -1), (-1, -1), (-1, 1))


def _floats(s: str | None, default=(0.0, 0.0, 0.0)):
    if s is None:
        return np.asarray(default, np.float64)
    return np.asarray([float(v) for v in s.split()], np.float64)


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis convention: R = Rz(yaw) · Ry(pitch) · Rx(roll)."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


@dataclass
class UrdfInertial:
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    # rotational inertia is about the CoM, expressed in the LINK frame
    # (the inertial-origin rpy is folded in at parse time).


@dataclass
class UrdfLink:
    name: str
    inertial: UrdfInertial | None = None


@dataclass
class UrdfJoint:
    name: str
    type: str
    parent: str
    child: str
    origin_xyz: np.ndarray
    origin_rot: np.ndarray  # (3,3)
    axis: np.ndarray
    effort: float | None = None
    velocity: float | None = None
    lower: float | None = None
    upper: float | None = None
    damping: float = 0.0
    friction: float = 0.0


@dataclass
class UrdfRobot:
    name: str
    links: dict[str, UrdfLink]
    joints: dict[str, UrdfJoint]

    def children_of(self, link: str) -> list[UrdfJoint]:
        return [j for j in self.joints.values() if j.parent == link]

    def root_link(self) -> str:
        children = {j.child for j in self.joints.values()}
        roots = [n for n in self.links if n not in children]
        if len(roots) != 1:
            raise ValueError(f"expected one root link, found {roots}")
        return roots[0]

    def chain(self, start_joint: UrdfJoint) -> list[UrdfJoint]:
        """Follow the (single-branch) chain hanging off a joint."""
        out = [start_joint]
        while True:
            nxt = self.children_of(out[-1].child)
            if not nxt:
                return out
            if len(nxt) > 1:
                raise ValueError(
                    f"branching chain at link {out[-1].child}"
                )
            out.append(nxt[0])


def load_urdf(path: str) -> UrdfRobot:
    """Parse a URDF file into links/joints (no external deps)."""
    root = ET.parse(path).getroot()
    if root.tag != "robot":
        raise ValueError(f"not a URDF robot file: {path}")

    links: dict[str, UrdfLink] = {}
    for le in root.findall("link"):
        name = le.attrib["name"]
        inertial = None
        ie = le.find("inertial")
        if ie is not None:
            oe = ie.find("origin")
            xyz = _floats(oe.get("xyz") if oe is not None else None)
            rpy = _floats(oe.get("rpy") if oe is not None else None)
            mass = float(ie.find("mass").attrib["value"])
            ine = ie.find("inertia")
            a = {k: float(ine.attrib.get(k, 0.0)) for k in
                 ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")}
            imat = np.array(
                [
                    [a["ixx"], a["ixy"], a["ixz"]],
                    [a["ixy"], a["iyy"], a["iyz"]],
                    [a["ixz"], a["iyz"], a["izz"]],
                ]
            )
            rot = rpy_to_matrix(rpy)
            inertial = UrdfInertial(
                mass=mass, com=xyz, inertia=rot @ imat @ rot.T
            )
        links[name] = UrdfLink(name=name, inertial=inertial)

    joints: dict[str, UrdfJoint] = {}
    for je in root.findall("joint"):
        name = je.attrib["name"]
        oe = je.find("origin")
        xyz = _floats(oe.get("xyz") if oe is not None else None)
        rpy = _floats(oe.get("rpy") if oe is not None else None)
        ax = je.find("axis")
        axis = _floats(ax.get("xyz") if ax is not None else None, (1, 0, 0))
        lim = je.find("limit")
        dyn = je.find("dynamics")
        joints[name] = UrdfJoint(
            name=name,
            type=je.attrib["type"],
            parent=je.find("parent").attrib["link"],
            child=je.find("child").attrib["link"],
            origin_xyz=xyz,
            origin_rot=rpy_to_matrix(rpy),
            axis=axis,
            effort=float(lim.attrib["effort"]) if lim is not None else None,
            velocity=float(lim.attrib["velocity"]) if lim is not None else None,
            lower=float(lim.attrib["lower"]) if lim is not None else None,
            upper=float(lim.attrib["upper"]) if lim is not None else None,
            damping=float(dyn.attrib.get("damping", 0.0))
            if dyn is not None else 0.0,
            friction=float(dyn.attrib.get("friction", 0.0))
            if dyn is not None else 0.0,
        )
    return UrdfRobot(name=root.attrib.get("name", ""), links=links,
                     joints=joints)


_RX_NEG90 = rpy_to_matrix((-math.pi / 2, 0.0, 0.0))


def robot_model_from_urdf(
    path: str = SIMPLEDOG_URDF,
    dtype=torch.float32,
    vmc_base_mass: float | None = None,
    vmc_leg_mass: float | None = None,
    hip_offset: np.ndarray | None = None,
    limb_config=None,
    device=None,
) -> RobotModel:
    """Build a :class:`RobotModel` from a 4×3-DoF quadruped URDF.

    ``vmc_base_mass`` / ``vmc_leg_mass`` override the lumped masses used
    by the virtual-model controller (the reference hard-codes 27 kg /
    6 kg per leg in ``quadruped_state.cpp:28-36`` regardless of its URDF
    inertials; pass them to replicate that semantics — unset, the
    URDF-summed masses are used). ``hip_offset`` overrides the virtual
    hip used by the Raibert heuristic (reference: (±0.42, ±0.075, 0));
    it defaults to the kinematic hip origins. ``limb_config`` is the
    per-leg IK branch name sequence (default ``DEFAULT_LIMB_CONFIG``).
    The model is made on ``device`` (default CUDA; raises where it is
    absent).
    """
    dev = resolve_device(device)
    robot = load_urdf(path)
    base = robot.root_link()

    # one chain of ≥3 revolute joints per leg
    chains = []
    for j in robot.children_of(base):
        chain = robot.chain(j)
        rev = [c for c in chain if c.type in ("revolute", "continuous")]
        if len(rev) == 3:
            chains.append((chain, rev))
    if len(chains) != 4:
        raise ValueError(
            f"expected 4 three-DoF legs off {base}, found {len(chains)}"
        )

    # order by hip-origin quadrant: LF, RF, RH, LH
    def quadrant(entry):
        xyz = entry[1][0].origin_xyz
        return (int(np.sign(xyz[0])), int(np.sign(xyz[1])))

    by_quad = {quadrant(e): e for e in chains}
    if set(by_quad) != set(_LEG_SIGNS):
        raise ValueError(f"unrecognized hip layout: {sorted(by_quad)}")
    ordered = [by_quad[s] for s in _LEG_SIGNS]

    hip_pos, hip_rot = [], []
    link_mass, link_com, link_inertia = [], [], []
    leg_masses = []
    d = l1 = l2 = None
    effort = None
    damping = 0.0
    for chain, rev in ordered:
        haa, hfe, kfe = rev
        for j in rev:
            if not np.allclose(j.axis, (0.0, 0.0, 1.0)):
                raise ValueError(
                    f"joint {j.name}: only z-axis revolute joints supported"
                )
        hip_pos.append(haa.origin_xyz)
        hip_rot.append(haa.origin_rot)
        if not np.allclose(hfe.origin_rot, _RX_NEG90, atol=1e-9):
            raise ValueError(
                f"joint {hfe.name}: hip-to-thigh rotation must be Rx(-π/2) "
                "(the analytic-leg convention)"
            )
        if not np.allclose(hfe.origin_xyz, 0.0):
            raise ValueError(f"joint {hfe.name}: expected zero offset")
        # kfe origin (l1, 0, d); fixed foot joint (l2, 0, 0)
        tail = [c for c in chain if c.type == "fixed"]
        if not tail:
            raise ValueError(f"leg {haa.name}: missing fixed foot joint")
        foot = tail[-1]
        leg_d, leg_l1 = kfe.origin_xyz[2], kfe.origin_xyz[0]
        leg_l2 = foot.origin_xyz[0]
        if d is None:
            d, l1, l2 = leg_d, leg_l1, leg_l2
        elif not np.allclose((d, l1, l2), (leg_d, leg_l1, leg_l2)):
            raise ValueError("legs have differing geometry")

        masses = []
        if not link_mass:  # per-link inertials from the first leg
            for j in rev:
                inert = robot.links[j.child].inertial
                if inert is None:
                    raise ValueError(f"link {j.child} has no inertial")
                link_mass.append(inert.mass)
                link_com.append(inert.com)
                link_inertia.append(inert.inertia)
        for j in rev:
            masses.append(robot.links[j.child].inertial.mass)
        leg_masses.append(sum(masses))
        effort = rev[0].effort if effort is None else effort
        damping = max(damping, max(j.damping for j in rev))

    base_inertial = robot.links[base].inertial
    if base_inertial is None:
        raise ValueError("base link has no inertial")
    base_mass = (
        float(vmc_base_mass) if vmc_base_mass is not None
        else base_inertial.mass
    )
    leg_mass = (
        np.full(4, float(vmc_leg_mass)) if vmc_leg_mass is not None
        else np.asarray(leg_masses)
    )
    hip_pos = np.asarray(hip_pos)
    hip_off = hip_pos if hip_offset is None else np.asarray(hip_offset)

    # lumped base inertia: URDF base inertia + leg point masses at the
    # (virtual) hips (parallel-axis), as in RobotModel.simpledog().
    base_inertia = base_inertial.inertia.copy()
    for m, r in zip(leg_mass, hip_off):
        base_inertia += m * (np.dot(r, r) * np.eye(3) - np.outer(r, r))

    config = limb_config or DEFAULT_LIMB_CONFIG
    branch = torch.tensor([IK_BRANCH[c] for c in config], device=dev)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev).to(dtype)  # noqa: E731
    return RobotModel(
        hip_pos=f(hip_pos),
        hip_rot=f(np.asarray(hip_rot)),
        d=f(d),
        l1=f(l1),
        l2=f(l2),
        ik_branch=branch,
        hip_offset=f(hip_off),
        base_mass=f(base_mass),
        leg_mass=f(leg_mass),
        com_in_base=f(base_inertial.com),
        link_mass=f(np.asarray(link_mass)),
        link_com=f(np.asarray(link_com)),
        link_inertia=f(np.asarray(link_inertia)),
        torque_limit=f(300.0 if effort is None else effort),
        base_inertia=f(base_inertia),
        joint_damping=f(damping),
    )
