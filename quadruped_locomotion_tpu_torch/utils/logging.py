"""Observability: ring-buffer logging on the device, host timers and
profiler regions (≙ ``quadruped_locomotion_tpu/utils/logging.py``).

* :class:`RingLog` — fixed-capacity buffers over a sample tree (a tensor,
  a dict or a dataclass of tensors) with a write cursor; :func:`record`
  is pure and reads nothing back to the host (an ``index_copy`` per leaf
  at a cursor kept on the device), so it may run inside a tick captured
  as a CUDA graph.
* :func:`capture` — the reference's ``/capture_log_data``: one copy of the
  cursor and count, then the buffers, returned oldest first.
* :class:`Timer` — pin/split wall-clock timing with named laps.
* :func:`trace_annotation` — a named region in ``torch.profiler`` traces;
  :func:`start_profiler` / :func:`stop_profiler` — a profiler session that
  writes a Chrome trace into a log directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

DEFAULT_CAPACITY = 10_000  # ≙ the reference controller's ring buffers


def _tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tensor tree: {type(tree)!r}")


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    _tree_map(lambda t: out.append(t) or t, tree)
    return out


@dataclass
class RingLog:
    """Fixed-capacity ring buffer over a sample tree."""

    buffers: Any  # tree; each leaf (capacity, *sample_shape)
    cursor: torch.Tensor  # () int32: the next write slot
    total: torch.Tensor  # () int32: samples ever written

    @property
    def capacity(self) -> int:
        return _leaves(self.buffers)[0].shape[0]


def ring_log(sample: Any, capacity: int = DEFAULT_CAPACITY) -> RingLog:
    """A log sized for ``sample``'s tree, on the sample's device."""
    bufs = _tree_map(lambda x: torch.zeros((capacity,) + tuple(x.shape),
                                           dtype=x.dtype, device=x.device),
                     sample)
    dev = _leaves(bufs)[0].device
    return RingLog(buffers=bufs,
                   cursor=torch.zeros((), dtype=torch.int32, device=dev),
                   total=torch.zeros((), dtype=torch.int32, device=dev))


def record(log: RingLog, sample: Any) -> RingLog:
    """Append one sample (pure; no host read)."""
    idx = log.cursor.reshape(1).long()
    bufs = _tree_map(lambda buf, x: torch.index_copy(
        buf, 0, idx, x.to(buf.dtype).unsqueeze(0)), log.buffers, sample)
    return RingLog(buffers=bufs,
                   cursor=torch.remainder(log.cursor + 1, log.capacity),
                   total=log.total + 1)


def capture(log: RingLog):
    """≙ ``/capture_log_data``: the samples on the host (numpy), oldest
    first, with a leading time axis of ``min(total, capacity)``."""
    total, cursor = (int(v) for v in torch.stack(
        [log.total, log.cursor]).cpu().tolist())
    cap = log.capacity
    n = min(total, cap)

    def order(buf):
        host = buf.detach().cpu().numpy()
        if total <= cap:
            return host[:n]
        return np.concatenate([host[cursor:], host[:cursor]], axis=0)

    return _tree_map(order, log.buffers)


class Timer:
    """Wall-clock pin/split timer with named laps
    (≙ ``std_utils::HighResolutionClockTimer``)."""

    def __init__(self):
        self._pins: dict[str, float] = {}
        self.laps: dict[str, list[float]] = {}

    def pin(self, name: str = "default") -> None:
        self._pins[name] = time.perf_counter()

    def split(self, name: str = "default") -> float:
        dt = time.perf_counter() - self._pins[name]
        self.laps.setdefault(name, []).append(dt)
        return dt

    def mean(self, name: str = "default") -> float:
        xs = self.laps.get(name, [])
        return sum(xs) / len(xs) if xs else float("nan")

    @contextlib.contextmanager
    def lap(self, name: str = "default"):
        self.pin(name)
        try:
            yield self
        finally:
            self.split(name)


def trace_annotation(name: str):
    """A named region in ``torch.profiler`` traces, for host-side stages."""
    return torch.profiler.record_function(name)


_PROFILER: dict = {}


def start_profiler(logdir: str) -> None:
    """Start a ``torch.profiler`` session (CPU, and CUDA where a card is
    present) whose Chrome trace :func:`stop_profiler` writes to
    ``logdir``."""
    if _PROFILER:
        raise RuntimeError("a profiler session is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _PROFILER.update(prof=prof, logdir=logdir)


def stop_profiler() -> str:
    """End the session; returns the path of the Chrome trace written."""
    prof, logdir = _PROFILER.pop("prof"), _PROFILER.pop("logdir")
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path
