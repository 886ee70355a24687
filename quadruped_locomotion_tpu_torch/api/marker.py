"""Headless interactive foothold and trajectory-knot editing (≙
``quadruped_locomotion_tpu/api/marker.py``, the reference's
``free_gait_marker``).

The reference's operator drags per-leg foothold markers and trajectory
knot markers in RViz and sends the edited step as an ``ExecuteSteps``
goal. Here a :class:`MarkerSession` holds named marker positions,
initialized at the robot's live feet, edited by calls or by the
command language of :func:`repl` (``cli edit``), and sent mid-run as
single-step goals to a live
:class:`~..runtime.action_server.FreeGaitActionServer`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import messages as msg

LEG_INDEX = {name: i for i, name in enumerate(msg.LEG_NAMES)}


def _canon_leg(leg: str) -> str:
    leg = leg.upper()
    if not leg.endswith("_LEG"):
        leg = leg + "_LEG"
    if leg not in LEG_INDEX:
        raise KeyError(f"unknown leg {leg!r}; want one of {msg.LEG_NAMES}")
    return leg


@dataclass
class _KnotTrack:
    """Editable knot list for one leg's end-effector trajectory."""

    times: list[float] = field(default_factory=list)
    positions: list[tuple[float, float, float]] = field(
        default_factory=list
    )


class MarkerSession:
    """Live foothold/knot markers over a running action server.

    ≙ ``MarkerManager``: markers are placed at the current foot
    positions, edited (drag ≙ :meth:`set_foothold`/:meth:`nudge`),
    and SENT mid-run as single-step goals (menu "send" ≙
    :meth:`send_foothold` / :meth:`send_trajectory`). Without ``server``,
    a server for the simpledog on ``device`` (default CUDA; raises where
    it is absent) is made.
    """

    def __init__(self, server=None, height: float = 0.4, device=None):
        if server is None:
            from ..runtime.action_server import FreeGaitActionServer
            from ..types import RobotModel

            server = FreeGaitActionServer(RobotModel.simpledog(device),
                                          device=device)
        self.server = server
        self.height = height
        self.footholds: dict[str, np.ndarray] = {}
        self.knots: dict[str, _KnotTrack] = {}
        self.sent_goals: list[int] = []
        self.reset_markers()

    # -- marker placement (≙ drag events) ------------------------------

    def reset_markers(self) -> None:
        """Place every foothold marker at the robot's LIVE foot position
        (≙ setupFootholdMarkers at current feet)."""
        feet = self._live_feet()
        for name, i in LEG_INDEX.items():
            self.footholds[name] = feet[i].copy()

    def _live_feet(self) -> np.ndarray:
        """The robot's feet (4, 3), copied to the host once."""
        return self.server.state.sim.feet_world.detach().cpu().numpy()

    def set_foothold(self, leg: str, xyz) -> np.ndarray:
        leg = _canon_leg(leg)
        self.footholds[leg] = np.asarray(xyz, np.float64)
        return self.footholds[leg]

    def nudge(self, leg: str, dxyz) -> np.ndarray:
        """Relative drag of a foothold marker."""
        leg = _canon_leg(leg)
        self.footholds[leg] = self.footholds[leg] + np.asarray(
            dxyz, np.float64
        )
        return self.footholds[leg]

    def add_knot(self, leg: str, t: float, xyz) -> None:
        """Append a trajectory knot marker for ``leg`` (≙ the knot
        markers of MarkerManager.cpp:260-300)."""
        leg = _canon_leg(leg)
        track = self.knots.setdefault(leg, _KnotTrack())
        track.times.append(float(t))
        track.positions.append(tuple(float(v) for v in xyz))

    def set_knot(self, leg: str, i: int, xyz) -> None:
        """Drag knot ``i`` of ``leg``'s trajectory to a new position."""
        leg = _canon_leg(leg)
        track = self.knots[leg]
        track.positions[i] = tuple(float(v) for v in xyz)

    # -- send (≙ the marker menu's "send" entries) -----------------------

    def foothold_goal(self, leg: str) -> msg.ExecuteStepsGoal:
        """One-footstep goal from the leg's marker (+BaseAuto), exactly
        the step free_gait_marker composes (MarkerManager.cpp:87-200)."""
        leg = _canon_leg(leg)
        tgt = tuple(float(v) for v in self.footholds[leg])
        return msg.ExecuteStepsGoal(
            steps=[
                msg.StepMsg(
                    footsteps=[msg.FootstepMsg(name=leg, target=tgt)],
                    base_auto=msg.BaseAutoMsg(height=self.height),
                )
            ],
        )

    def send_foothold(self, leg: str, **submit_kw) -> int:
        gid = self.server.submit_goal(self.foothold_goal(leg), **submit_kw)
        self.sent_goals.append(gid)
        return gid

    def trajectory_goal(self, leg: str) -> msg.ExecuteStepsGoal:
        leg = _canon_leg(leg)
        track = self.knots[leg]
        if not track.times:
            raise ValueError(f"no knots recorded for {leg}")
        knots = [
            msg.TrajectoryKnotMsg(time=t, position=p)
            for t, p in zip(track.times, track.positions)
        ]
        return msg.ExecuteStepsGoal(
            steps=[
                msg.StepMsg(
                    end_effector_trajectories=[
                        msg.EndEffectorTrajectoryMsg(name=leg, knots=knots)
                    ],
                    base_auto=msg.BaseAutoMsg(height=self.height),
                )
            ],
        )

    def send_trajectory(self, leg: str, **submit_kw) -> int:
        gid = self.server.submit_goal(self.trajectory_goal(leg), **submit_kw)
        self.sent_goals.append(gid)
        return gid

    # -- observation ----------------------------------------------------

    def describe(self) -> str:
        feet = self._live_feet()
        lines = ["leg      marker (world)            live foot"]
        for name, i in LEG_INDEX.items():
            m = self.footholds[name]
            lines.append(
                f"{name:<8} [{m[0]:+.3f} {m[1]:+.3f} {m[2]:+.3f}]  "
                f"[{feet[i][0]:+.3f} {feet[i][1]:+.3f} {feet[i][2]:+.3f}]"
            )
        for name, track in self.knots.items():
            for j, (t, p) in enumerate(zip(track.times, track.positions)):
                lines.append(
                    f"{name} knot[{j}] t={t:.2f} "
                    f"[{p[0]:+.3f} {p[1]:+.3f} {p[2]:+.3f}]"
                )
        return "\n".join(lines)


def repl(session: MarkerSession, lines, out=print) -> None:
    """Drive a MarkerSession from an iterable of command lines — the
    headless stand-in for the RViz drag-and-menu interaction. Used by
    ``cli edit`` (stdin) and tests (lists).

    Commands:
      show                         print markers + live feet
      foot LEG X Y [Z]             place a foothold marker
      nudge LEG DX DY [DZ]         relative drag
      knot LEG T X Y Z             append a trajectory knot
      setknot LEG I X Y Z          move knot I
      send LEG                     send the leg's foothold goal (mid-run)
      sendtraj LEG                 send the leg's knot trajectory
      tick [N]                     advance the server N planner ticks
      wait                         run until the queue drains
      quit
    """
    for raw in lines:
        parts = raw.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        cmd, args = parts[0].lower(), parts[1:]
        try:
            if cmd == "show":
                out(session.describe())
            elif cmd == "foot":
                p = [float(v) for v in args[1:]] + [0.0]
                out(str(session.set_foothold(args[0], p[:3])))
            elif cmd == "nudge":
                p = [float(v) for v in args[1:]] + [0.0]
                out(str(session.nudge(args[0], p[:3])))
            elif cmd == "knot":
                session.add_knot(
                    args[0], float(args[1]), [float(v) for v in args[2:5]]
                )
            elif cmd == "setknot":
                session.set_knot(
                    args[0], int(args[1]), [float(v) for v in args[2:5]]
                )
            elif cmd == "send":
                out(f"goal {session.send_foothold(args[0])}")
            elif cmd == "sendtraj":
                out(f"goal {session.send_trajectory(args[0])}")
            elif cmd == "tick":
                session.server.run(int(args[0]) if args else 1)
            elif cmd == "wait":
                session.server.run_until_done()
                out("queue drained")
            elif cmd in ("quit", "exit"):
                return
            else:
                out(f"? unknown command {cmd!r}")
        except (KeyError, ValueError, IndexError) as exc:
            out(f"! {exc}")
