"""Action and collection registry (≙ ``quadruped_locomotion_tpu/api/
action_loader.py``'s ``ActionRegistry`` and ``default_registry``).

Declaration files keep the reference's schema (``actions/*.yaml``,
``collections/*.yaml`` under a root, or a bare directory of motion
scripts). :func:`default_registry` reads the JAX package's bundled
action library and motion scripts in place, by path, as data: they are
framework-free YAML, shared by both packages rather than copied.

"Send" compiles a YAML motion script to a :class:`StepSchedule`; the
closed loop (``rollout/script_loop.py``) or the kinematic preview
(``rollout/preview.py``) executes it. Python, launch and combined-YAML
actions are listed but not run: they need the action server and action
classes, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterable

import yaml

from ..planning.steps import StepSchedule
from . import actions as actions_mod

# the bundled library: data files of the JAX package, read in place
BUNDLED_LIBRARY = (Path(os.path.abspath(__file__)).parents[2]
                   / "quadruped_locomotion_tpu" / "api" / "action_library")


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
                f"action {action_id!r} is a {entry.type!r} action; the port "
                "runs yaml motion scripts only (its action server and action "
                "classes are not ported yet)")
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
