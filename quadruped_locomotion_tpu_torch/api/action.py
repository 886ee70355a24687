"""Programmatic action lifecycle: ActionBase, Simple, Continuous,
Combined (≙ ``quadruped_locomotion_tpu/api/action.py``, the reference's
``free_gait_python`` action machinery).

A state machine (ERROR/UNINITIALIZED/INITIALIZED/PENDING/ACTIVE/IDLE/DONE)
wraps a goal relayed to the in-process
:class:`~..runtime.action_server.FreeGaitActionServer`; the host pumps
``server.tick()`` and the callbacks fire synchronously from the tick.
Goals sent by :attr:`ActionBase.goal` are compiled at send time against
the server's live robot state: an :class:`~.messages.ExecuteStepsGoal`, a
motion-script document (``dict`` with ``steps:``) or a compiled
:class:`~..planning.steps.StepSchedule`. :class:`TriggerOnFeedback` is the
reference's feedback trigger (queue_size <= n and phase >= p) and
:class:`SubprocessAction` spawns an external process (the reference's
LaunchAction without roslaunch).
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys

import yaml

from ..planning.steps import StepSchedule
from . import messages as msg


class ActionState:
    """≙ free_gait.action.ActionState (same codes)."""

    ERROR = -1
    UNINITIALIZED = 0
    INITIALIZED = 1
    PENDING = 2
    ACTIVE = 3
    IDLE = 4
    DONE = 5

    _TEXT = {
        -1: "Error",
        0: "Uninitialized",
        1: "Initialized",
        2: "Pending",
        3: "Active",
        4: "Idle",
        5: "Done",
    }

    @staticmethod
    def to_text(state):
        return ActionState._TEXT.get(state)


def replace_placeholders(obj, placeholders):
    """Recursive string-value substitution — ≙
    ``free_gait.py::replace_placeholders`` (:112-127), which swaps any
    string VALUE equal to a placeholder key (not text interpolation)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, str) and v in placeholders:
                obj[k] = placeholders[v]
            else:
                replace_placeholders(v, placeholders)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            if isinstance(v, str) and v in placeholders:
                obj[i] = placeholders[v]
            else:
                replace_placeholders(v, placeholders)
    return obj


class ActionBase:
    """Base lifecycle. ``server`` is the relay (FreeGaitActionServer)."""

    def __init__(self, server):
        self.server = server
        self.state = ActionState.UNINITIALIZED
        self.feedback_callback = None
        self.done_callback = None
        self.goal = None
        self.goal_id: int | None = None
        self.feedback: msg.ExecuteStepsFeedback | None = None
        self.result: msg.ExecuteStepsResult | None = None
        self.set_state(ActionState.INITIALIZED)

    # -- state machine (≙ action.py set_state/register_callback) --------

    def set_state(self, state) -> None:
        if state == self.state:
            return
        self.state = state
        if state == ActionState.DONE:
            if self.done_callback:
                self.done_callback()
        elif self.feedback_callback:
            self.feedback_callback()

    def register_callback(self, feedback_callback=None, done_callback=None):
        self.feedback_callback = feedback_callback
        self.done_callback = done_callback

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Started by the loader when INITIALIZED. Subclasses send their
        goal (or begin their computation) here."""

    def stop(self) -> None:
        """Stopped by the loader — preempt per the server's stored mode
        and finish (≙ ActionBase.stop → stop_tracking_goal + DONE)."""
        if self.state in (ActionState.PENDING, ActionState.ACTIVE):
            self.server.stop()
        self.set_state(ActionState.DONE)

    def wait_for_state(self, states, max_ticks: int = 10_000) -> bool:
        """Pump the server until this action reaches one of ``states``
        (≙ WaitForState, with server ticks in place of wall-clock)."""
        if not isinstance(states, (list, tuple, set)):
            states = (states,)
        for _ in range(max_ticks):
            if self.state in states:
                return True
            self.server.tick()
        return self.state in states

    # -- goal plumbing ---------------------------------------------------

    def _send_goal(self) -> None:
        """≙ ActionBase._send_goal (:96-121): no goal → empty result +
        DONE; otherwise submit and go PENDING."""
        if self.goal is None:
            self.result = msg.ExecuteStepsResult()
            self.set_state(ActionState.DONE)
            return
        cbs = dict(feedback_cb=self._feedback_callback,
                   result_cb=self._result_callback)
        if isinstance(self.goal, msg.ExecuteStepsGoal):
            self.goal_id = self.server.submit_goal(self.goal, **cbs)
        elif isinstance(self.goal, dict):
            self.goal_id = self.server.submit_doc(self.goal, **cbs)
        elif isinstance(self.goal, StepSchedule):
            self.goal_id = self.server.submit_rows(self.goal, **cbs)
        else:
            raise TypeError(f"unsupported goal type {type(self.goal)!r}")
        self.set_state(ActionState.PENDING)

    def _feedback_callback(self, feedback) -> None:
        """Feedback flips PENDING → ACTIVE (≙ _active_callback — our
        in-process server has no separate accept handshake). An IDLE
        continuous action with a goal still executing (the merged queue
        holds several of its goals at once) also reads as ACTIVE."""
        self.feedback = feedback
        if self.state in (ActionState.PENDING, ActionState.IDLE):
            self.set_state(ActionState.ACTIVE)
        self.on_feedback(feedback)

    def on_feedback(self, feedback) -> None:
        """Override to trigger behavior on execution progress
        (≙ overwriting _feedback_callback)."""

    def _result_callback(self, result) -> None:
        """≙ _done_callback (:133-141): ERROR on abort, else terminal."""
        self.result = result
        if result.status == msg.RESULT_ABORTED:
            self.set_state(ActionState.ERROR)
        else:
            self.set_state(self._terminal_state())

    def _terminal_state(self):
        return ActionState.DONE


class SimpleAction(ActionBase):
    """One known goal at initialization (≙ SimpleAction)."""

    def __init__(self, server, goal):
        super().__init__(server)
        self.goal = goal

    def start(self) -> None:
        super().start()
        self._send_goal()


class ContinuousAction(ActionBase):
    """Runs until stopped: a finished goal parks the action in IDLE
    instead of DONE (≙ ContinuousAction._done_callback), from where a
    subclass (or its feedback hook) sends the next goal."""

    def start(self) -> None:
        super().start()
        self._send_goal()

    def _terminal_state(self):
        return ActionState.IDLE


class CombinedYamlAction(ActionBase):
    """Combination of YAML motion scripts with placeholder substitution
    (≙ CombinedYamlAction + CombinedYamlActionDefinition). The combined
    document's steps are concatenated in order and compiled against the
    robot state at send time."""

    def __init__(self, server):
        super().__init__(server)
        self.state = ActionState.UNINITIALIZED
        self.goal = None

    def set_goal_from_yaml(self, yaml_object, base_dir: str = ".") -> None:
        if not yaml_object or "yaml_actions" not in yaml_object:
            self.set_state(ActionState.ERROR)
            return
        global_ph = yaml_object.get("global_placeholders") or {}
        combined: dict = {"steps": []}
        for item in yaml_object["yaml_actions"]:
            a = item.get("action", item)
            path = a.get("file_path")
            if not path:
                self.set_state(ActionState.ERROR)
                return
            if not os.path.isabs(path):
                # relative paths resolve against the combined file (the
                # reference resolves via rospack package lookup instead)
                path = os.path.normpath(os.path.join(base_dir, path))
            with open(path) as f:
                doc = yaml.safe_load(f)
            ph = dict(global_ph)
            ph.update(a.get("placeholders") or {})
            doc = replace_placeholders(copy.deepcopy(doc), ph)
            # first doc's frame adaptation wins (like goal.steps concat)
            if "adapt_coordinates" in doc and "adapt_coordinates" not in combined:
                combined["adapt_coordinates"] = doc["adapt_coordinates"]
            combined["steps"].extend(doc.get("steps", []))
        self.goal = combined
        self.set_state(ActionState.INITIALIZED)

    def set_goal_from_file(self, file_path: str) -> None:
        try:
            with open(file_path) as f:
                self.set_goal_from_yaml(
                    yaml.safe_load(f), os.path.dirname(file_path)
                )
        except FileNotFoundError:
            self.set_state(ActionState.ERROR)

    def start(self) -> None:
        super().start()
        self._send_goal()


class TriggerOnFeedback:
    """≙ action.py::TriggerOnFeedback (:326-336): fires when the step
    queue has drained to ``n_steps_in_queue`` and the current step's
    phase passed ``phase_of_step``."""

    def __init__(self, n_steps_in_queue: int, phase_of_step: float):
        self.n_steps_in_queue = n_steps_in_queue
        self.phase_of_step = phase_of_step

    def check(self, feedback) -> bool:
        if feedback is None:
            return False
        return (
            feedback.queue_size <= self.n_steps_in_queue
            and feedback.phase >= self.phase_of_step
        )


class SubprocessAction(ActionBase):
    """External-process action (the capability of the reference's
    LaunchAction without roslaunch): spawn a child, ACTIVE while it
    runs, DONE on exit 0, ERROR otherwise. Call :meth:`poll` (the
    loader does, each pump) to observe termination."""

    def __init__(self, server, argv, python: bool = True):
        super().__init__(server)
        self.argv = ([sys.executable] + list(argv)) if python else list(argv)
        self.proc: subprocess.Popen | None = None

    def start(self) -> None:
        try:
            self.proc = subprocess.Popen(self.argv)
        except OSError:
            self.set_state(ActionState.ERROR)
            return
        self.set_state(ActionState.ACTIVE)

    def poll(self) -> None:
        if self.proc is None or self.state != ActionState.ACTIVE:
            return
        rc = self.proc.poll()
        if rc is None:
            return
        self.set_state(ActionState.DONE if rc == 0 else ActionState.ERROR)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        super().stop()
