"""Carry weights and state between the JAX package and the port.

The exchange format is a nested dict of numpy arrays keyed by dataclass
field name, mirroring the JAX package's dataclasses and NamedTuples
(``RobotModel``, ``ControllerParams`` = (vmc, cfd, swing), ``GaitParams``,
``LocomotionState`` = (sim, gait, fsm) with the swing-spline tables,
``SimState`` of either plant (the articulated one keeps its pinned feet's
anchors in ``feet_world``), ``QpSolution``, ``Heightfield``,
``EstimatorState``, and scripted motion's ``StepSchedule``, ``ExecState``
(its ``inf`` time before the first step included), ``FsmState``,
``ScriptState`` and the preview's ``StateBatch``). Batched objects keep
the JAX package's vmapped
layout, a leading scenario axis on every leaf: one map per scenario in a
``Heightfield``, (B,) and (B,2) leaves in per-scenario ``GaitParams``.
:func:`from_numpy` builds any of the port's objects on a device, e.g.
``from_numpy(LocomotionState, tree, "cuda")``; :func:`to_numpy` is the
reverse. Producing the dict from JAX objects is the caller's side
(this package does not import JAX). For ``.npz`` files, :func:`unflatten`
turns ``"a/b/c"`` keys back into the nested dict.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .types import resolve_device


def _is_struct(cls) -> bool:
    """A dataclass or a NamedTuple class."""
    return dataclasses.is_dataclass(cls) or (
        isinstance(cls, type) and issubclass(cls, tuple)
        and hasattr(cls, "_fields"))


def _field_names(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)


def _build(cls, tree: dict, device: torch.device):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name in _field_names(cls):
        kind = hints[name]
        value = tree[name]
        if _is_struct(kind):
            kwargs[name] = _build(kind, value, device)
        else:
            kwargs[name] = torch.as_tensor(np.asarray(value), device=device)
    return cls(**kwargs)


def from_numpy(cls, tree: dict, device=None):
    """Any of the port's tensor dataclasses or NamedTuples (e.g.
    ``SimState``, ``QpSolution``) from its nested numpy dict, on
    ``device`` (default CUDA)."""
    return _build(cls, tree, resolve_device(device))


def to_numpy(obj):
    """Port object (dataclass / NamedTuple / dict / tensor tree) -> nested
    dict of numpy arrays in the same layout."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return np.asarray(obj)


def unflatten(flat, prefix: str = "") -> dict:
    """{"a/b": x, "a/c": y} -> {"a": {"b": x, "c": y}}, keeping only keys
    under ``prefix`` (e.g. "ls0/") with the prefix removed."""
    out: dict = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return out
