"""Action and collection registry and the action loader (≙
``quadruped_locomotion_tpu/api/action_loader.py``).

Declaration files keep the reference's schema (``actions/*.yaml``,
``collections/*.yaml`` under a root, or a bare directory of motion
scripts). :func:`default_registry` reads the port's own bundled action
library (``action_library/`` here) and, through its relative ``file:``
paths, the port's ``motion_scripts/``: copies of the JAX package's files,
byte for byte, apart from the python action, whose port imports this
package instead of the JAX one.

:meth:`ActionRegistry.compile` turns a YAML motion script into a
:class:`StepSchedule` for the closed loop (``rollout/script_loop.py``) or
the kinematic preview (``rollout/preview.py``). Python, launch and
combined-YAML actions run through :class:`ActionLoader` against a live
:class:`~..runtime.action_server.FreeGaitActionServer`.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterable

import yaml

from ..planning.steps import StepSchedule
from . import actions as actions_mod

# the bundled action library
BUNDLED_LIBRARY = Path(os.path.abspath(__file__)).parent / "action_library"


@dataclasses.dataclass(frozen=True)
class ActionEntry:
    """One declared action."""

    id: str
    name: str
    file: str  # absolute path to the motion script
    type: str = "yaml"
    description: str = ""


@dataclasses.dataclass(frozen=True)
class CollectionEntry:
    """A named group of actions."""

    id: str
    name: str
    action_ids: tuple[str, ...]
    is_sequence: bool = False


class ActionRegistry:
    """Discovers and serves actions and collections from declaration
    roots: ``actions/*.yaml`` declarations and ``collections/*.yaml``
    under a root, or a bare directory of motion scripts (each one an
    action, id = file stem)."""

    #: the declared action types
    TYPES = ("yaml", "combined_yaml", "python", "launch")

    def __init__(self, roots: Iterable[str] | None = None):
        self._roots: list[str] = []
        self.actions: dict[str, ActionEntry] = {}
        self.collections: dict[str, CollectionEntry] = {}
        for r in roots or []:
            self.add_root(r)

    def add_root(self, root: str) -> None:
        self._roots.append(os.path.abspath(root))
        self.update()

    def update(self) -> None:
        """Re-scan every root."""
        self.actions.clear()
        self.collections.clear()
        for root in self._roots:
            decl_dir = os.path.join(root, "actions")
            if os.path.isdir(decl_dir):
                for fn in sorted(os.listdir(decl_dir)):
                    if fn.endswith((".yaml", ".yml")):
                        self._load_action_decls(os.path.join(decl_dir, fn),
                                                root)
                coll_dir = os.path.join(root, "collections")
                if os.path.isdir(coll_dir):
                    for fn in sorted(os.listdir(coll_dir)):
                        if fn.endswith((".yaml", ".yml")):
                            self._load_collection_decls(
                                os.path.join(coll_dir, fn))
            else:  # a bare directory of motion scripts
                for fn in sorted(os.listdir(root)):
                    if fn.endswith((".yaml", ".yml")):
                        stem = os.path.splitext(fn)[0]
                        self.actions[stem] = ActionEntry(
                            id=stem, name=stem.replace("_", " "),
                            file=os.path.join(root, fn))

    def _load_action_decls(self, path: str, root: str) -> None:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for item in doc.get("actions", []) or []:
            a = item.get("action", item)
            atype = str(a.get("type", "yaml"))
            if atype not in self.TYPES:
                continue
            entry = ActionEntry(
                id=str(a["id"]), name=str(a.get("name", a["id"])),
                file=os.path.normpath(os.path.join(root, a["file"])),
                type=atype, description=str(a.get("description", "")))
            self.actions[entry.id] = entry

    def _load_collection_decls(self, path: str) -> None:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for item in doc.get("collections", []) or []:
            c = item.get("collection", item)
            entry = CollectionEntry(
                id=str(c["id"]), name=str(c.get("name", c["id"])),
                action_ids=tuple(str(x) for x in c.get("actions", [])),
                is_sequence=bool(c.get("is_sequence", False)))
            self.collections[entry.id] = entry

    def list_actions(self, collection_id: str | None = None):
        if collection_id is None:
            return sorted(self.actions.values(), key=lambda a: a.id)
        coll = self.collections[collection_id]
        return [self.actions[i] for i in coll.action_ids if i in self.actions]

    def list_collections(self):
        return sorted(self.collections.values(), key=lambda c: c.id)

    def compile(self, action_id: str, base_pos, base_quat, feet_world,
                device=None) -> StepSchedule:
        """Motion script → StepSchedule against the given robot state, on
        ``device`` (default CUDA). Raises NotImplementedError for the
        action types that need the action server."""
        entry = self.actions[action_id]
        if entry.type != "yaml":
            raise NotImplementedError(
                f"action {action_id!r} is a {entry.type!r} action, which does "
                "not compile to one schedule: run it through ActionLoader")
        return actions_mod.load_action(entry.file, base_pos, base_quat,
                                       feet_world, device=device)

    def compile_sequence(self, collection_id: str, base_pos, base_quat,
                         feet_world, device=None) -> list[StepSchedule]:
        """The schedules of a sequence collection, in order, all compiled
        against the given state."""
        coll = self.collections[collection_id]
        if not coll.is_sequence:
            raise ValueError(f"collection {collection_id} is not a sequence")
        return [self.compile(a, base_pos, base_quat, feet_world, device)
                for a in coll.action_ids]


def default_registry() -> ActionRegistry:
    """Registry over the bundled action library."""
    return ActionRegistry([str(BUNDLED_LIBRARY)])


class ActionLoader:
    """Runs registry actions through the action lifecycle against a live
    :class:`~..runtime.action_server.FreeGaitActionServer` (≙ the
    reference's ActionLoader node): one current action at a time, built
    per type (yaml, combined_yaml, python, launch), started when
    INITIALIZED, sequences chained from the done callback. The host pumps
    :meth:`pump` (one server tick plus subprocess polling each).

    Without ``server``, a server for the simpledog on ``device`` (default
    CUDA; raises where it is absent) is made."""

    def __init__(self, server=None, registry: ActionRegistry | None = None,
                 device=None):
        from . import action as action_mod

        if server is None:
            from ..runtime.action_server import FreeGaitActionServer
            from ..types import RobotModel

            server = FreeGaitActionServer(RobotModel.simpledog(device),
                                          device=device)
        self._A = action_mod
        self.server = server
        self.registry = registry or default_registry()
        self.action = None  # the current ActionBase
        self.action_sequence_queue: list[str] = []
        self.state_log: list[int] = []  # lifecycle transitions observed

    def send_action(self, action_id: str):
        """Load and start the action; returns the live ActionBase (KeyError
        for unknown ids). Purges any pending sequence (≙ the reference's
        per-service purge): a direct send interrupts a running sequence."""
        self.action_sequence_queue = []
        return self._send_action_internal(action_id)

    def _send_action_internal(self, action_id: str):
        self.reset()
        entry = self.registry.actions[action_id]
        A = self._A
        if entry.type == "yaml":
            with open(entry.file) as f:
                doc = yaml.safe_load(f)
            self.action = A.SimpleAction(self.server, doc)
        elif entry.type == "combined_yaml":
            act = A.CombinedYamlAction(self.server)
            act.set_goal_from_file(entry.file)
            self.action = act
        elif entry.type == "python":
            self.action = self._load_python_action(entry.file)
        elif entry.type == "launch":
            self.action = A.SubprocessAction(self.server, [entry.file])
        else:  # filtered at discovery
            raise ValueError(entry.type)

        self.action.register_callback(self._feedback_callback,
                                      self._done_callback)
        if self.action.state == A.ActionState.INITIALIZED:
            self.action.start()
        return self.action

    def _load_python_action(self, file_path: str):
        """Execute the script, which must leave an ``action`` object
        behind; it sees ``server``, ``action_loader`` and the action API
        as ``free_gait_action``."""
        ns = {"server": self.server, "action_loader": self,
              "free_gait_action": self._A}
        with open(file_path) as f:
            code = f.read()
        exec(compile(code, file_path, "exec"), ns)
        if "action" not in ns:
            raise ValueError(f"{file_path} did not define `action`")
        return ns["action"]

    def send_action_sequence(self, action_ids) -> None:
        """Run actions back to back: each DONE starts the next."""
        ids = list(action_ids)
        if not ids:
            return
        self._send_action_internal(ids[0])
        self.action_sequence_queue = ids[1:]

    def pump(self, n_ticks: int = 1) -> None:
        """Advance the server and poll process actions."""
        for _ in range(n_ticks):
            self.server.tick()
            if self.action is not None and hasattr(self.action, "poll"):
                self.action.poll()

    def pump_until(self, states, max_ticks: int = 20_000) -> bool:
        """Pump until the current action reaches one of ``states``."""
        if not isinstance(states, (list, tuple, set)):
            states = (states,)
        for _ in range(max_ticks):
            if self.action is not None and self.action.state in states:
                return True
            self.pump()
        return self.action is not None and self.action.state in states

    def _feedback_callback(self) -> None:
        if self.action is not None:
            self.state_log.append(self.action.state)

    def _done_callback(self) -> None:
        if self.action is not None:
            self.state_log.append(self.action.state)
        if not self.action_sequence_queue:
            return
        if self.action is None or self.action.state != self._A.ActionState.DONE:
            self.action_sequence_queue = []  # an error purges the rest
            return
        next_id = self.action_sequence_queue.pop(0)
        try:
            self._send_action_internal(next_id)
        except (KeyError, ValueError, OSError):
            # an unknown id or an unreadable action file ends the sequence
            # in the ERROR state instead of raising out of server.tick()
            # (≙ the reference's purge on a failed load)
            self.action_sequence_queue = []
            self.action = None
            self.state_log.append(self._A.ActionState.ERROR)

    def reset(self) -> None:
        """Stop and drop the current action."""
        if self.action is not None and self.action.state in (
                self._A.ActionState.PENDING, self._A.ActionState.ACTIVE,
                self._A.ActionState.IDLE):
            self.action.stop()
        self.action = None
